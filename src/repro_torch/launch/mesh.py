"""Device meshes of the port (``repro/launch/mesh.py``) over
``torch.distributed``: one rank per device, the same axis names as the JAX
package (``("data", "model")``, and ``("pod", "data", "model")`` for the
multi-pod mesh).

Defined as FUNCTIONS (never module-level constants): importing this module
joins no process group and touches no device, as the JAX module touches no
devices.  :func:`init_distributed` joins the default group: NCCL for the
card, gloo for the CPU (no fallback from one to the other), the rendezvous
from the environment that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), or, for a single process started without
it, world size 1 on a free local port.
"""
from __future__ import annotations

import datetime
import os
import socket

import torch

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device="cuda", timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Joins the default process group unless this process is in one
    already -> True when this call created it.  ``device``'s type picks the
    backend: NCCL for ``cuda`` (raises where NCCL is not built in), gloo for
    ``cpu``.  On the card each rank takes ``cuda:LOCAL_RANK``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh on the card needs NCCL, and this torch has none")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    else:
        rank, world, init_method = 0, 1, f"tcp://127.0.0.1:{_free_port()}"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=timeout)
    return True


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    default group, in rank order (row-major over the axes)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_test_mesh(data: int = 2, model: int = 2, device="cuda"):
    """Small ``(data, model)`` mesh for multi-process tests."""
    return make_mesh((data, model), ("data", "model"), device)
