"""Multi-pod dry run of the port (counterpart of ``repro/launch/dryrun.py``):
trace rank 0's per-device program of every (architecture x input shape)
cell on the production meshes, and record its memory, FLOPs, bytes and
collectives per device for the roofline (``launch/roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

One JSON per cell under experiments/dryrun_torch/ (an ok record is kept;
``--force`` redoes it).  The trace is the test: a per-rank block that breaks
a kernel's limit fails with that kernel's own error (its meta contract,
``kernels/ops.py``), a layout the mesh does not divide fails in the sharding
rules, and a value-dependent op fails on meta: here, not on the cluster.

JAX lowers and compiles each cell for 512 forced host devices.  The port
runs eagerly, so it runs rank 0's program once, as it would run on the
cluster, with three stand-ins: meta tensors (shapes and dtypes; nothing is
drawn, allocated or computed), a ``fake`` process group of the mesh's 256
or 512 ranks (its collectives return at once and move nothing), and the
cost count of ``launch/cost_analysis.py`` around the step.  The mapping is
the one JAX's dry run gives the cell (:func:`use_fsdp_mapping`), installed
as JAX installs it: ``sharding.set_mesh(mesh, data_only=...)``.  Rank 0's
program stands for every rank's, since every block of a mesh axis has one
shape.  The dry run makes its own fake group, refuses to run inside a real
one, and never initializes CUDA.

A record has JAX's keys where they have a counterpart (``arch, shape, mesh,
axes, kind, argument_size_in_bytes, output_size_in_bytes,
alias_size_in_bytes, temp_size_in_bytes`` = peak less arguments,
``flops_per_device, bytes_per_device, collective_bytes, ok, error,
traceback``), plus ``mapping`` ("fsdp" or "tp"), ``trace_s``,
``peak_bytes``, ``collective_bytes_by_axis`` and ``axis_ranks`` (the ranks
of rank 0's group on each axis, from which the roofline tells an NVLink
domain from the network).  ``cache_bytes`` is a decode cell's cache in the
port's own TP layout: each rank holds its rows and its kv heads
(``transformer.init_cache``), not JAX's sequence split (``cache_specs`` in
the JAX module), so long_500k at batch 1 holds the whole 524,288-token
cache of its heads on every rank.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from repro_torch.configs import SHAPES, cells_for_arch, get_config, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataConfig, batch_specs
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.elastic import reshard_state
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as model_lib
from repro_torch.train.trainer import TrainConfig, make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


# ------------------------------------------------------------- input specs --
def input_specs(arch: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta stand-ins for every model input of the global batch."""
    if shape.kind == "train":
        return batch_specs(DataConfig(arch.vocab, shape.seq_len, shape.global_batch), arch)
    if shape.kind == "prefill":
        dc = DataConfig(arch.vocab, shape.seq_len - arch.prefix_len, shape.global_batch)
        specs = batch_specs(dc, arch)
        specs.pop("labels")
        return specs
    # decode: one new token against a cache of seq_len
    return {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")}


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _axis_size(mesh, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    sizes = sh.mesh_shape(mesh)
    out = 1
    for n in names:
        out *= sizes[n]
    return out


def batch_sharding_spec(mesh, batch: int, data_only: bool = False):
    """The axes the batch shards over (JAX's rule), or None where none
    divides it.  ``mesh``: a DeviceMesh, or anything with a ``shape`` dict."""
    names = tuple(sh.mesh_shape(mesh))
    if data_only:
        if _div(batch, _axis_size(mesh, names)):
            return names
    ba = tuple(a for a in ("pod", "data") if a in names)
    if ba and _div(batch, _axis_size(mesh, ba)):
        return ba
    # try data alone
    if "data" in names and _div(batch, sh.mesh_shape(mesh)["data"]):
        return ("data",)
    return None


def use_fsdp_mapping(arch: ArchConfig, shape: ShapeSpec, mesh) -> bool:
    """JAX's rule: the FSDP/ZeRO-3 mapping for non-MoE train / prefill when
    the batch splits over every device and the params are under 2e10,
    else the tensor-parallel mapping."""
    if arch.n_experts or shape.kind == "decode":
        return False
    return shape.global_batch % sh.mesh_size(mesh) == 0 and arch.param_count() < 2e10


# ---------------------------------------------------- shape-only state ----
class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta: ``init_params`` given it builds
    meta tensors, the counterpart of ``jax.eval_shape(init_params)`` (a
    meta op draws and computes nothing)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def meta_params(arch: ArchConfig, w_bits=None, device="meta"):
    """A full config's params as meta tensors; with ``w_bits``, quantized as
    the serving paths hold them (``transformer.quantize_params``).  On
    another ``device``, the same params drawn from seed 0 (the card's run
    of a cell)."""
    dev = torch.device(device)
    gen = (_MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(0))
    params = model_lib.init_params(arch, gen)
    return params if w_bits is None else model_lib.quantize_params(params, w_bits)


def _local(t: torch.Tensor, rows: slice, device) -> torch.Tensor:
    """``t``'s rows ``rows`` with a storage of their own on ``device``:
    empty on meta, zeros (valid token ids) elsewhere."""
    return torch.zeros((rows.stop - rows.start, *t.shape[1:]), dtype=t.dtype, device=device)


class Cell(NamedTuple):
    """Rank 0's program of a cell: ``run()`` executes it once on
    ``arguments`` (its params, optimizer state, batch and cache)."""

    run: Callable
    arguments: tuple
    mapping: str
    rows: int
    whole_batch: bool


def build_cell(arch: ArchConfig, shape: ShapeSpec, mesh, device="meta") -> Cell:
    """The counterpart of JAX's ``build_lowered``: installs the cell's
    mapping as JAX's dry run does (``set_mesh(mesh, data_only=...)``; the
    caller removes it) and builds rank 0's shape-only state under it.  A
    batch the batch axes do not divide (long_500k's one row) is held whole
    on every rank, as JAX replicates it (``sharding.whole_batch``).  A
    decode step attends its whole cache (the position at its last slot).
    On another ``device`` (a mesh over a real group), the same program on
    real tensors: ``chip_smoke.py`` holds the dry run against it."""
    fsdp = use_fsdp_mapping(arch, shape, mesh)
    sh.set_mesh(mesh, data_only=fsdp)
    axes = batch_sharding_spec(mesh, shape.global_batch, data_only=fsdp)
    if axes is not None and tuple(axes) != sh.batch_axes():
        raise NotImplementedError(f"the batch splits over {axes}, and the port's model code "
                                  f"over {sh.batch_axes()}")
    whole = axes is None and sh.batch_ranks() > 1
    rows = slice(0, shape.global_batch) if whole else sh.batch_rows(shape.global_batch)
    batch = {k: _local(v, rows, device) for k, v in input_specs(arch, shape).items()}
    mapping = "fsdp" if fsdp else "tp"

    def cell(run, *arguments):
        return Cell(run, arguments, mapping, rows.stop - rows.start, whole)

    if shape.kind == "train":
        step_fn, opt_init = make_train_step(arch, TrainConfig(microbatches=1), mesh)
        params = meta_params(arch, device=device)
        opt_state = reshard_state(opt_init(params), mesh)
        params = reshard_state(params, mesh)
        return cell(lambda: step_fn(params, opt_state, batch, 0), params, opt_state, batch)
    # serving paths run on quantized weights (the paper's technique)
    with sh.whole_batch() if whole else contextlib.nullcontext():
        qparams = reshard_state(meta_params(arch, arch.serve_w_bits, device), mesh)
        if shape.kind == "prefill":
            return cell(lambda: model_lib.prefill(qparams, batch, arch, shape.seq_len),
                        qparams, batch)
        cache = model_lib.init_cache(arch, rows.stop - rows.start, shape.seq_len, device)

    def decode():
        cache["pos"].fill_(shape.seq_len - 1)
        return model_lib.decode_step(qparams, batch["tokens"], cache, arch)

    return cell(decode, qparams, batch, cache)


def _storages(tree) -> dict[int, int]:
    """{storage key: bytes} of the tensors of ``tree``."""
    out = {}
    for t in cost_analysis._tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def trace_cell(cell: Cell, mesh) -> dict:
    """Runs the cell's program once under the cost count -> the record's
    numbers."""
    args = _storages(cell.arguments)
    t0 = time.perf_counter()
    with sh.whole_batch() if cell.whole_batch else contextlib.nullcontext():
        out, cost = cost_analysis.analyze(cell.run, arguments=cell.arguments, mesh=mesh)
    trace_s = time.perf_counter() - t0
    outs = _storages(out)
    return {
        "argument_size_in_bytes": cost["argument_bytes"],
        "output_size_in_bytes": sum(outs.values()),
        "alias_size_in_bytes": sum(n for k, n in outs.items() if k in args),
        "temp_size_in_bytes": cost["peak_bytes"] - cost["argument_bytes"],
        "peak_bytes": cost["peak_bytes"],
        "flops_per_device": cost["flops"],
        "bytes_per_device": cost["hbm_bytes"],
        "collective_bytes": cost["collective_bytes"],
        "collective_bytes_by_axis": cost["collective_bytes_by_axis"],
        "kernel_calls": cost["kernel_calls"],
        "ops": cost["ops"],
        "loop_mult": cost["loop_mult"],
        "trace_s": trace_s,
    }


# ---------------------------------------------------------- fake group -----
@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` process group of ``size`` ranks, this process rank 0:
    collectives return at once and move nothing.  The backend is torch's
    testing one, whose API is not stable, imported here alone.  Refuses to
    run inside a real process group."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group, and this process "
                           f"is in a {dist.get_backend()} group already")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=size, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def axis_ranks(mesh) -> dict[str, list[int]]:
    """The global ranks of rank 0's group on each axis of ``mesh``."""
    import torch.distributed as dist

    return {a: dist.get_process_group_ranks(mesh.get_group(a)) for a in mesh.mesh_dim_names}


def dry_run(arch: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    """One cell on ``mesh`` (a DeviceMesh over a fake group): the record's
    layout and cost fields; a failure raises."""
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch, shape, mesh)
        build_s = time.perf_counter() - t0
        rec = {"mapping": cell.mapping, "rows": cell.rows, "whole_batch": cell.whole_batch,
               "batch_axes": list(sh.batch_axes()) if not cell.whole_batch else [],
               "build_s": build_s, **trace_cell(cell, mesh)}
        if shape.kind == "decode":
            rec["cache_bytes"] = sum(_storages(cell.arguments[2]).values())
        return rec
    finally:
        sh.set_mesh(None)


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2" if multi_pod else "pod1"


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, mesh,
             force: bool = False) -> dict:
    """One cell's record, written to OUT_DIR (an ok record on disk is reused
    unless ``force``).  ``mesh``: the production mesh over a fake group of
    its size (:func:`main` makes one for all cells of a mesh)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out_path = OUT_DIR / f"{arch_name}__{shape_name}__{_mesh_tag(multi_pod)}.json"
    if out_path.exists() and not force:
        cached = json.loads(out_path.read_text())
        if cached.get("ok"):  # failed cells always re-run
            return cached
    arch, shape = get_config(arch_name), SHAPES[shape_name]
    rec: dict = {"arch": arch_name, "shape": shape_name,
                 "mesh": list(sh.mesh_shape(mesh).values()), "axes": list(mesh.mesh_dim_names),
                 "kind": shape.kind, "axis_ranks": axis_ranks(mesh)}
    t0 = time.perf_counter()
    try:
        rec.update(dry_run(arch, shape, mesh))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, don't mask others
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["cell_s"] = time.perf_counter() - t0
    out_path.write_text(json.dumps(rec, indent=1))
    status = "OK" if rec["ok"] else f"FAIL: {rec['error'][:200]}"
    print(f"[dryrun] {arch_name} x {shape_name} x {_mesh_tag(multi_pod)}: {status} "
          f"({rec['cell_s']:.1f} s)", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in list_archs() for s in cells_for_arch(get_config(a))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")
    failures = 0
    t0 = time.perf_counter()
    for mp in meshes:
        with fake_world(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp, device="cpu")
            for a, s in cells:
                rec = run_cell(a, s, mp, mesh, force=args.force)
                failures += 0 if rec.get("ok") else 1
    print(f"[dryrun] done; {len(cells) * len(meshes)} cell-runs, {failures} failures, "
          f"{time.perf_counter() - t0:.1f} s")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
