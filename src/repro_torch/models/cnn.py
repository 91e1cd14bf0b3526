"""The paper's CNN benchmarks (VGG16 / ResNet18 / GoogLeNet / SqueezeNet) run
on the port's multi-precision conv path, with the mixed FF/CF dataflow
selector choosing each layer's matmul order.  Port of ``repro/models/cnn.py``.

The networks are built from the cycle model's layer tables
(``models/cnn_zoo.py``): every convolution runs through ``ops.mpconv``, whose
matmul core is the FF-order or the CF-order dequant kernel.  The topology is
the JAX package's sequential trace of the conv workload (pooling and
branching replaced by shape adaptation: a nearest resize and channel
tiling), since the paper's metric covers convolutional layers only.  Weights
are random, drawn from a ``torch.Generator``; they are not the JAX package's
numbers (``models/convert.py`` carries those over when a test needs them).

Both functions run on the card unless the caller names another device, and
raise when there is none.  On the card the activations are bf16, the
kernels' type; the CPU's plain versions take f32 as well.
"""
from __future__ import annotations

import torch

from repro_torch.core.dataflow import ConvLayer
from repro_torch.core.isa import Dataflow
from repro_torch.core.perfmodel import SpeedModel, select_dataflow
from repro_torch.core.precision import Precision
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.cnn_zoo import BENCHMARK_NETWORKS

__all__ = ["init_network", "run_network", "resize_nearest"]


def init_network(net: str, seed: int = 0, w_bits: int = 8, *, device=None):
    """Random weights for every conv layer, quantized and packed:
    ``(layers, [(w_data, w_scale), ...])``.  As in the JAX package, w4 raises
    ``ValueError`` for a layer whose K = cin*k*k is odd (int4 packs K in
    pairs): every network's first conv."""
    dev = resolve_device(device)
    layers = BENCHMARK_NETWORKS[net]()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = []
    for l in layers:
        w = torch.randn(l.k, l.k, l.cin, l.cout, generator=gen, device=dev) / (
            l.k * (l.cin ** 0.5)
        )
        params.append(ops.conv_pack_weights(w, w_bits))
    return layers, params


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (n, h, w, c), "nearest")`` on NHWC: source index
    floor((i + 0.5) * in / out) in float32, as JAX computes it (this is
    ``F.interpolate``'s "nearest-exact", not its "nearest").  An index
    gather, so integer dtypes work too."""
    for dim, size in ((1, h), (2, w)):
        src = x.shape[dim]
        if src == size:
            continue
        pos = (torch.arange(size, dtype=torch.float32, device=x.device) + 0.5) * src / size
        x = x.index_select(dim, torch.floor(pos).long())
    return x


def run_network(
    net: str,
    x: torch.Tensor,  # [N, H, W, 3]
    params,
    layers: list[ConvLayer],
    *,
    w_bits: int = 8,
    strategy: str = "mixed",
    device=None,
):
    """Chains the conv layers; returns (activations, per-layer dataflow
    decisions ``"<layer>: ff|cf"``).  ``strategy`` is ``"mixed"`` (the
    selector per layer), ``"ff"`` or ``"cf"``.  ``x`` must already be on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    if x.device.type != dev.type or dev.index not in (None, x.device.index):
        raise ValueError(f"x is on {x.device}; the network runs on {dev}")
    model = SpeedModel()
    decisions: list[str] = []
    for layer, (wd, ws) in zip(layers, params):
        # adapt the running activation to this layer's expected input shape
        if x.shape[1] != layer.h or x.shape[3] != layer.cin:
            x = resize_nearest(x, layer.h, layer.w)
            if x.shape[3] != layer.cin:
                reps = -(-layer.cin // x.shape[3])
                x = x.repeat(1, 1, 1, reps)[..., : layer.cin]
        if strategy == "mixed":
            df = select_dataflow(layer, Precision.from_bits(w_bits), model)
            dataflow = "ff" if df is Dataflow.FF else "cf"
        else:
            dataflow = strategy
        decisions.append(f"{layer.name}: {dataflow}")
        x = ops.mpconv(
            x, wd, ws, w_bits=w_bits, ksize=layer.k, stride=layer.stride,
            padding=layer.padding, mode="dequant", dataflow=dataflow,
        )
        x = torch.relu(x)
    return x, decisions
