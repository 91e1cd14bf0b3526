"""Checkpointing: atomic, async, keep-N (port of
``repro/checkpoint/manager.py``, with its on-disk layout).

Layout per step:

    <dir>/step_000000123.tmp/       (written first)
        manifest.json               step, dtypes, n_leaves, digest, meta
        arr_00000.npy ...           one file per leaf, in flattening order
    <dir>/step_000000123/           (atomic rename when complete)

Leaves are ordered as ``jax.tree_util`` orders them (``optim/tree.py``:
dict keys sorted, tuples in order), bf16 leaves are stored as their 16-bit
pattern (``uint16``) with ``"bfloat16"`` in ``dtypes``: a directory the
JAX package's manager wrote restores here leaf for leaf, and the digest of
the same tree is the same string.

  * **atomicity**: a checkpoint is visible iff its final rename happened;
    crashed writers leave only ``.tmp`` dirs, which restore ignores and the
    next save prunes.
  * **async**: ``save(..., blocking=False)`` copies the leaves to host
    memory synchronously and writes them on a background thread; the train
    loop loses only the device->host copy.
  * **keep-N**: bounded disk usage.
  * ``restore(target=...)`` puts each leaf on its target leaf's device and
    dtype; with ``shardings=`` (a matching tree of
    ``distributed.sharding.NamedSharding``) each rank takes only its block
    of each leaf, so a job restarts on a different mesh shape
    (``distributed/elastic.py``).  Leaves are saved host-gathered.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.convert import tensor_to_numpy
from repro_torch.optim import tree as tree_lib

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf's host copy (a copy even of a CPU leaf: the train step updates
    its tensors in place while the write runs) and its dtype name as the
    JAX package writes it."""
    a = tensor_to_numpy(t)
    return a, "bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if str(a.dtype) != dtype:
        raise ValueError(f"leaf stored as {a.dtype}, manifest says {dtype}")
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- helpers --
    def _path(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.dir, f"step_{step:09d}" + (".tmp" if tmp else ""))

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             blocking: bool = True) -> None:
        # snapshot to host synchronously (cheap relative to the write)
        host = [_to_host(leaf) for leaf in tree_lib.leaves(tree)]

        def write():
            tmp = self._path(step, tmp=True)
            final = self._path(step)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, (arr, _) in enumerate(host):
                np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr)
            manifest = {
                "step": step,
                "dtypes": [dt for _, dt in host],
                "n_leaves": len(host),
                "digest": hashlib.sha256(
                    "".join(f"{a.shape}{dt}" for a, dt in host).encode()
                ).hexdigest(),
                "meta": meta or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(tmp)
            else:
                os.replace(tmp, final)
            self._gc()

        self.wait()
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)
        for name in os.listdir(self.dir):  # orphaned tmp dirs from crashes
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # ----------------------------------------------------------- restore --
    def restore(self, step: Optional[int] = None, target: Any = None, shardings: Any = None):
        """Loads ``step`` (default latest) -> (tree, manifest).  ``target``:
        a tree prototype whose structure the leaves fill, each moved to its
        target leaf's device and dtype; without one, the flat list of CPU
        tensors.  ``shardings``: a tree of ``NamedSharding`` matching
        ``target``: each leaf becomes this rank's block under its sharding
        (``sharding.shard_local``), on the target leaf's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = [_from_host(np.load(os.path.join(path, f"arr_{i:05d}.npy")), dt)
                  for i, dt in enumerate(manifest["dtypes"])]
        if target is None:
            return leaves, manifest
        protos = tree_lib.leaves(target)
        if len(protos) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, the target {len(protos)}")
        if shardings is None:
            placed = [a.to(device=p.device, dtype=p.dtype) for a, p in zip(leaves, protos)]
        else:
            from repro_torch.distributed.sharding import shard_local

            placed = [shard_local(a.to(dtype=p.dtype), s, device=p.device)
                      for a, p, s in zip(leaves, protos, tree_lib.leaves(shardings))]
        return tree_lib.unflatten(target, placed), manifest
