"""Carry JAX parameters, handed over as numpy arrays, into the port.

``params_from_numpy`` walks the tree of ``repro.models.transformer``
(``init_params`` / ``quantize_params``) after ``jax.tree.map(np.asarray,
...)``: quantized leaves are ``{"data", "scale", "bits"}`` dicts, the rest
are arrays.  bf16 arrays arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` refuses; they pass through their int16 bit pattern
instead, so no JAX or ml_dtypes import is needed here.

The same walk carries the ssm/hybrid trees (stacked ``blocks``, ``tail``,
the unstacked ``shared`` block) and the moe trees: ``blocks.moe.router``
[L, D, E] f32, the experts ``blocks.moe.{wg, wu, wd}`` [L, E, K, N] in bf16,
f32 or quantized expert by expert (``data`` [L, E, K (/2), N], ``scale``
[L, E, 1, N]), and the ``dense_blocks`` of a ``first_dense`` prefix.
``cache_from_numpy`` carries a contiguous decode cache of
``transformer.init_cache`` / ``prefill`` (``pos``, ``k``, ``v``,
``k_scale``, ``v_scale``, ``ssm``, ``ssm_tail``); ``pos`` becomes a 0-d
int32 tensor on ``device``, as the port's cache keeps it.

``params_to_numpy`` / ``opt_state_to_numpy`` go the other way, for the
training path's parity tests (parameters, gradients and optimizer states
against the JAX package's trees).

``cnn_params_from_numpy`` does the same for ``repro.models.cnn.init_network``'s
list of ``(w_data, w_scale)`` pairs.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy torch may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict[str, Any], device) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict) and set(leaf) == {"data", "scale", "bits"}:
            out[name] = {
                "data": tensor_from_numpy(leaf["data"], device),
                "scale": tensor_from_numpy(leaf["scale"], device),
                "bits": int(leaf["bits"]),
            }
        elif isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device)
        else:
            out[name] = tensor_from_numpy(leaf, device)
    return out


def cache_from_numpy(cache: dict[str, Any], device) -> dict[str, Any]:
    return {name: tensor_from_numpy(np.asarray(a, np.int32) if name == "pos" else a, device)
            for name, a in cache.items()}


def cnn_params_from_numpy(params, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``[(w_data, w_scale), ...]`` numpy pairs (one per conv layer) -> the
    same pairs as tensors on ``device``, bytes unchanged."""
    return [(tensor_from_numpy(wd, device), tensor_from_numpy(ws, device))
            for wd, ws in params]


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy (a copy even of a CPU tensor); bf16 goes out as
    its 16-bit pattern (``uint16``, as the checkpoints store it), so no
    ml_dtypes import is needed."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_numpy(tree: dict[str, Any]) -> dict[str, Any]:
    """The reverse of :func:`params_from_numpy` for float trees (parameters
    or gradients): every leaf through :func:`tensor_to_numpy`."""
    return {name: params_to_numpy(leaf) if isinstance(leaf, dict) else tensor_to_numpy(leaf)
            for name, leaf in tree.items()}


def opt_state_to_numpy(state) -> tuple[np.ndarray, Any]:
    """An ``optim.OptState`` -> (step, inner) in numpy, the inner dicts of
    the JAX optimizers' layout (adafactor's per-leaf ``{"r", "c"}`` or
    ``{"v"}``, adamw's ``{"m", "v"}`` trees, adamw8bit's ``{"q", "s"}``
    codes and scales)."""
    return tensor_to_numpy(state.step), params_to_numpy(state.inner)
