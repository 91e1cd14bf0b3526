"""Optimizers (port of ``repro/optim/optimizers.py``), over dict trees of
tensors.

Three state regimes:

  * ``adamw``      -- f32 m/v (8 bytes/param of state).
  * ``adamw8bit``  -- blockwise-int8 m/v with per-block f32 scales (~2.06
    bytes/param): the paper's quantization idea applied to optimizer state.
  * ``adafactor``  -- factored second moment, no first moment (O(rows + cols)
    state per matrix).

Each builder returns an :class:`Optimizer`: ``init(params) -> OptState``
and ``update(grads, state, params, lr) -> (updates, state)`` are the JAX
package's pure pair (new tensors, nothing of the arguments written); the
trainer uses ``apply(grads, state, params, lr) -> state``, the same
arithmetic written in place, parameter by parameter: ``params`` gain their
updates and ``state``'s tensors (the step counter too) take their new
values, so a captured train step replays on the same tensors, and at
full width no tree-wide copy of the state, the updates or the f32
gradients exists (at llama3.2-3b's width the f32 m and v alone are 28.9
GB).  Both run one per-parameter function, so they agree bit for bit.
Updates are pre-scaled by the LR (a 0-d f32 tensor from ``schedules``);
weight decay is decoupled.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.optim import tree


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32: updates applied so far
    inner: Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    apply: Callable
    # the per-parameter function both run, ``leaf(st, g, p, lr, t) -> (u,
    # st)``, and ``per_param(inner, params)``, the states it takes in
    # flattening order; ``elementwise``: each element of u and st depends
    # on the same element of g, p and st alone, so a block of them updates
    # on its own (``train/trainer.py``'s mesh step)
    leaf: Optional[Callable] = None
    per_param: Optional[Callable] = None
    elementwise: bool = False


def _optimizer(init: Callable, leaf: Callable, per_param: Callable,
               regroup: Callable, elementwise: bool = False) -> Optimizer:
    """The pure ``update`` and the in-place ``apply`` around ``leaf(st, g,
    p, lr, t) -> (u, st)``, which may write the per-parameter state ``st``
    in place: ``per_param(inner, params)`` lists those states in
    flattening order, ``regroup(states, params)`` is its inverse."""

    def update(grads, state: OptState, params, lr):
        t = state.step + 1
        outs = [leaf(tree.map(torch.clone, st), g, p, lr, t)
                for st, g, p in zip(per_param(state.inner, params), tree.leaves(grads),
                                    tree.leaves(params))]
        updates = tree.unflatten(params, [u for u, _ in outs])
        return updates, OptState(t, regroup([st for _, st in outs], params))

    @torch.no_grad()
    def apply(grads, state: OptState, params, lr) -> OptState:
        t = state.step + 1
        for st, g, p in zip(per_param(state.inner, params), tree.leaves(grads),
                            tree.leaves(params)):
            u, new = leaf(st, g, p, lr, t)
            for old, x in zip(tree.leaves(st), tree.leaves(new)):
                if x is not old:
                    old.copy_(x)
            p.add_(u)
            del u, new
        state.step.copy_(t)
        return state

    return Optimizer(init, update, apply, leaf, per_param, elementwise)


def _moments(inner, params) -> list:
    return list(zip(tree.subtrees(params, inner["m"]), tree.subtrees(params, inner["v"])))


def _unmoments(states, params) -> dict:
    return {"m": tree.unflatten(params, [m for m, _ in states]),
            "v": tree.unflatten(params, [v for _, v in states])}


def _zero_step(params) -> torch.Tensor:
    dev = tree.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ----------------------------------------------------------------- AdamW ----
def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, wd: float = 0.01) -> Optimizer:
    def init(params) -> OptState:
        zeros = tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return OptState(_zero_step(params), {"m": zeros, "v": tree.map(torch.clone, zeros)})

    def leaf(st, g, p, lr, t):
        """JAX's ``b1 * m + (1 - b1) * g`` and the bias-corrected update, m
        and v written in place, at most two f32 temporaries of the leaf."""
        m, v = st
        tf = t.float()
        gf = g.float()
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(torch.square(gf).mul_(1 - b2))
        del gf
        u = m / (1 - b1**tf)
        vh = v / (1 - b2**tf)
        u.div_(vh.sqrt_().add_(eps))
        del vh
        u.add_(p.float().mul_(wd) if p.dtype != torch.float32 else p * wd)
        return u.mul_(-lr).to(p.dtype), st

    return _optimizer(init, leaf, _moments, _unmoments, elementwise=True)


# ------------------------------------------------------------ 8-bit AdamW ----
_BLOCK = 256


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise 8-bit quantization with a quadratic codebook (flat f32 in,
    int8 code [blocks, 256] + per-block f32 scale [blocks, 1] out):
    value = scale * sign(q) * (|q|/127)^2, resolution concentrated near
    zero, where Adam's m/v live."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    blk = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = torch.clamp_min(blk.abs().amax(dim=1, keepdim=True), 1e-30)
    unit = blk / scale  # [-1, 1]
    # round(sign(u) * sqrt(|u|) * 127) clipped to +-127: the sign applied last
    # (exact, and rounding half to even is symmetric), in place
    q = unit.abs().sqrt_().mul_(127.0).round_().clamp_(max=127.0).copysign_(unit)
    return q.to(torch.int8), scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape, size: int) -> torch.Tensor:
    u = q.float().div_(127.0)
    val = torch.square(u).copysign_(u).mul_(scale)  # sign(u) * u^2 * scale
    return val.reshape(-1)[:size].reshape(shape)


def adamw8bit(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, wd: float = 0.01) -> Optimizer:
    """AdamW with int8 m/v (blockwise scales), ~4x less state than f32."""

    def init(params) -> OptState:
        def z(p):
            q, s = _q8(torch.zeros(p.numel(), dtype=torch.float32, device=p.device))
            return {"q": q, "s": s}

        return OptState(_zero_step(params), {"m": tree.map(z, params), "v": tree.map(z, params)})

    def leaf(st, g, p, lr, t):
        mq, vq = st
        tf = t.float()
        gf = g.float()
        m = _dq8(mq["q"], mq["s"], p.shape, p.numel()).mul_(b1).add_(gf * (1 - b1))
        v = _dq8(vq["q"], vq["s"], p.shape, p.numel()).mul_(b2).add_(
            torch.square(gf).mul_(1 - b2))
        del gf
        u = m / (1 - b1**tf)
        vh = v / (1 - b2**tf)
        u.div_(vh.sqrt_().add_(eps))
        del vh
        u.add_(p.float().mul_(wd) if p.dtype != torch.float32 else p * wd)
        u = u.mul_(-lr).to(p.dtype)
        (mq2, ms2), (vq2, vs2) = _q8(m), _q8(v)
        return u, ({"q": mq2, "s": ms2}, {"q": vq2, "s": vs2})

    return _optimizer(init, leaf, _moments, _unmoments)


# -------------------------------------------------------------- Adafactor ----
def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0, decay: float = 0.8,
              wd: float = 0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018): row and
    column statistics ``r`` / ``c`` for every leaf of ndim >= 2, a full
    ``v`` otherwise; updates clipped to RMS <= ``clip_threshold``."""

    def init(params) -> OptState:
        def z(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return OptState(_zero_step(params), tree.map(z, params))

    def leaf(st, g, p, lr, t):
        beta = 1.0 - (t.float() + 1.0) ** (-decay)
        gf = g.float()
        g2 = torch.square(gf).add_(eps)
        if p.ndim >= 2:
            r = beta * st["r"] + (1 - beta) * g2.mean(dim=-1)
            c = beta * st["c"] + (1 - beta) * g2.mean(dim=-2)
            del g2
            rmean = r.mean(dim=-1, keepdim=True)
            den = (r / torch.clamp_min(rmean, eps))[..., None] * c[..., None, :]  # vhat
            den.clamp_min_(eps)
            new = {"r": r, "c": c}
        else:
            v = beta * st["v"] + (1 - beta) * g2
            den = torch.clamp_min(v, eps)
            new = {"v": v}
        u = gf / den.sqrt_()
        del den, gf
        rms = torch.sqrt(torch.square(u).mean() + 1e-30)
        u.div_(torch.clamp_min(rms / clip_threshold, 1.0))
        u.add_(p.float() * wd)
        return u.mul_(-lr).to(p.dtype), new

    def per_param(inner, params) -> list:
        return tree.subtrees(params, inner)

    def regroup(states, params):
        return tree.unflatten(params, states)

    return _optimizer(init, leaf, per_param, regroup)


def make_optimizer(name: str, lr_unused: float = 0.0) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adamw8bit":
        return adamw8bit()
    if name == "adafactor":
        return adafactor()
    raise ValueError(f"unknown optimizer {name!r}")
