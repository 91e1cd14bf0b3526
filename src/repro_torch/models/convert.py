"""Carry a JAX parameter tree, handed over as numpy arrays, into the port.

``params_from_numpy`` walks the tree of ``repro.models.transformer``
(``init_params`` / ``quantize_params``) after ``jax.tree.map(np.asarray,
...)``: quantized leaves are ``{"data", "scale", "bits"}`` dicts, the rest
are arrays.  bf16 arrays arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` refuses; they pass through their int16 bit pattern
instead, so no JAX or ml_dtypes import is needed here.
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
