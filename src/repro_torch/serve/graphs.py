"""Captured steps: the port's counterpart of the JAX package's jits.

The JAX package runs every serving step as one compiled program: the
engine's ``_make_jits`` / ``_shared_jits`` (``prefill``, ``decode``,
``chunk``, ``spec``) and the static-wave ``Server``'s ``_prefill`` /
``_decode``; and the train step, ``jax.jit(step_fn, donate_argnums=(0,
1))`` in ``Trainer`` (``train/trainer.py`` captures it here too, over its
own static input buffers, ``run(..., static=True)``).  Here a fixed-shape
step is captured once as a
``torch.cuda.CUDAGraph`` and replayed: the same kernels, in the same order,
on the same buffers, without the host launching each of them again.

:class:`StepGraphs` holds one engine's (or one ``Server``'s) captured steps,
keyed by :func:`step_key`: the step, ``cfg`` (with the group's
``serve_kv_bits``), what the caller names static (the weight set's
``w_bits``, ``draft_bits``, ``spec_k``, the packed shapes: pow2 batch
bucket, pow2 table width, chunk length) and each input's shape and dtype,
with ``None`` where an optional input is absent (the structure of ``samp``:
an all-greedy group, or which of ``top_k`` / ``top_p`` a group uses).  Two
calls that differ only in values share a key, as they share a JAX jit.

For a new key, :meth:`StepGraphs.run` runs the step once eagerly (the
warm-up, whose result is the call's; it also builds the kernels), then
captures it under ``torch.cuda.graph`` into static input buffers holding
that call's inputs.  Capture records the kernels and does not run them, so
a step's K/V writes into the pools happen once.  Later calls copy their
inputs into the static buffers, ``replay()``, and return the static
outputs; the caller reads them before the next call.  All graphs of one
``StepGraphs`` share one memory pool (calls are sequential on one stream),
and each keeps its static inputs and outputs referenced, so a later
capture cannot reuse them.

A capture or a replay that fails raises; nothing falls back to eager.  On a
CPU device, and under :func:`disable_capture` (the counterpart of
``jax.disable_jit()``), every step runs eagerly.

The kernel wrappers count their launches on the host, and a replay runs no
Python: each graph keeps the counts its capture added (and takes them back
out, since capture ran nothing) and adds them again on every replay.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import mpmm, mqa_decode, paged_decode, paged_prefill

__all__ = ["StepGraphs", "disable_capture", "pack", "step_key", "unpack"]

# every launch counter of the kernel wrappers: (wrapper, attribute)
COUNTERS = (
    (mpmm.mpmm_cuda, "launches"),
    (mpmm.mpmm_cuda, "prefill_m_launches"),
    (mpmm.mpmm_cuda, "x32_launches"),
    (mpmm.mpmm_ff_cuda, "launches"),
    (mpmm.mpmm_ff_cuda, "x32_launches"),
    (mpmm.mpmm_int_cuda, "launches"),
    (mqa_decode.mqa_decode_cuda, "launches"),
    (paged_decode.paged_mqa_decode_cuda, "launches"),
    (paged_decode.paged_mqa_decode_cuda, "f32_launches"),
    (paged_prefill.paged_mqa_prefill_cuda, "launches"),
    (paged_prefill.paged_mqa_prefill_cuda, "f32_launches"),
    (paged_prefill.paged_mqa_prefill_cuda, "f32_merge_launches"),
)

_capture = True


@contextlib.contextmanager
def disable_capture():
    """Run every step eagerly inside the block (``jax.disable_jit()``)."""
    global _capture
    before = _capture
    _capture = False
    try:
        yield
    finally:
        _capture = before


def _structure(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    return tuple(_structure(v) for v in x)


def step_key(step: str, cfg, static: tuple, inputs) -> tuple:
    """The key of a captured step: what a JAX jit of it is keyed by (see
    the module note).  ``inputs`` is a tuple of tensors and ``None``s."""
    return step, cfg, tuple(static), _structure(inputs)


def pack(arrays) -> tuple[np.ndarray, tuple]:
    """Host integer arrays -> (one flat int32 array, their shapes): one
    host-to-device copy for all of a call's small inputs."""
    flat = np.concatenate([np.asarray(a, np.int32).ravel() for a in arrays])
    return flat, tuple(tuple(np.shape(a)) for a in arrays)


def unpack(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    """Contiguous views of a :func:`pack`-ed tensor, in ``shapes``."""
    parts = torch.split(flat, [math.prod(s) for s in shapes])
    return [p.view(s) for p, s in zip(parts, shapes)]


def _counts() -> list[int]:
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _add_counts(deltas) -> None:
    for (fn, attr), n in zip(COUNTERS, deltas):
        setattr(fn, attr, getattr(fn, attr) + n)


def _tensors(inputs) -> list[torch.Tensor]:
    return [t for t in inputs if t is not None]


@dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    inputs: tuple  # the static input buffers, None where an input is absent
    outputs: object  # the static outputs (a tensor or a tuple of them)
    launches: list  # each counter's increase per replay


class StepGraphs:
    """The captured steps of one engine or ``Server`` on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: dict[tuple, _Captured] = {}
        self._pool = None  # one graph memory pool for all of them
        self.calls: dict[tuple, int] = {}  # key -> calls, on any device
        self.capture_s = 0.0  # wall time spent capturing
        self.replays = 0

    @property
    def captured(self) -> int:
        return len(self._graphs)

    def run(self, key: tuple, fn, inputs: tuple, static: bool = False):
        """``fn(*inputs)``, captured per ``key`` on the card (module note).
        ``fn`` returns a tensor or a tuple of tensors.  ``static``: the
        inputs are the caller's own static buffers, which it refills before
        every call; the graph is captured over them as they are, and a
        replay copies nothing in."""
        self.calls[key] = self.calls.get(key, 0) + 1
        if self.device.type != "cuda" or not _capture:
            return fn(*inputs)
        g = self._graphs.get(key)
        if g is None:
            out = fn(*inputs)  # the warm-up: builds the kernels before any capture
            self._graphs[key] = self._capture(fn, inputs, static)
            return out
        for dst, src in zip(_tensors(g.inputs), _tensors(inputs)):
            if dst is not src:
                dst.copy_(src)
        g.graph.replay()
        _add_counts(g.launches)
        self.replays += 1
        return g.outputs

    def _capture(self, fn, inputs: tuple, own: bool = False) -> _Captured:
        t0 = time.perf_counter()
        static = inputs if own else tuple(None if t is None else t.clone() for t in inputs)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                outputs = fn(*static)
        finally:
            after = _counts()
            _add_counts([b - a for b, a in zip(before, after)])  # nothing ran
        self.capture_s += time.perf_counter() - t0
        return _Captured(graph, static, outputs, [a - b for a, b in zip(after, before)])
