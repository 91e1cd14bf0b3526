"""Elastic scaling (port of ``repro/distributed/elastic.py``): rebuild the
mesh for whatever ranks survive and reshard the checkpointed state onto it.

The contract: training state is checkpointed host-gathered
(``checkpoint/manager.py``), the data pipeline is a pure function of (seed,
step), and parameter shardings are derived from name-pattern rules, so
restoring onto a DIFFERENT mesh shape is just ``make_elastic_mesh(n)`` plus
a restore with the new shardings.  Nothing about the training state encodes
the old topology.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import shard_local, tree_shardings
from repro_torch.optim import tree


def make_elastic_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                      device="cuda"):
    """Largest (data, model) mesh over the first ``n_devices`` ranks of the
    default group (all of them by default).  model_parallel must divide
    the count; the ranks left out hold no coordinate in the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = min(n_devices or world, world)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    data = n // model_parallel
    ranks = torch.arange(n, dtype=torch.int64).view(data, model_parallel)
    return DeviceMesh(torch.device(device).type, ranks, mesh_dim_names=("data", "model"))


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def reshard_state(state, mesh):
    """A state tree of full tensors -> this rank's blocks of it under the
    standard rules, on the mesh's device (the counterpart of
    ``jax.device_put`` onto the shardings: a rank holds only its shards).
    A meta tensor's block stays on meta: the dry run's shape-only state."""
    sh = tree_shardings(state, mesh)
    dev = mesh_device(mesh)

    def place(a, s):
        if not torch.is_tensor(a):
            return a
        return shard_local(a, s, device=None if a.is_meta else dev)

    return tree.map(place, state, sh)
