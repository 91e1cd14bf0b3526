"""Roofline of the port's dry-run records (counterpart of
``repro/launch/roofline.py``), with an NVIDIA H100 SXM's constants.

For each (arch x shape) cell, the three terms of rank 0's per-device
program (``launch/dryrun.py``):

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = sum over mesh axes of the axis's wire bytes / its link's rate

plus MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (prefill, decode)
and the usefulness ratio MODEL_FLOPS / (the trace's FLOPs on all devices).

H100 SXM constants (NVIDIA's data sheet, as the ``hopper-kernels`` guide's
table gives them; dense rates at the full 700 W power limit):

* PEAK_FLOPS = 989e12 FLOP/s, bf16 on the tensor cores;
* HBM_BW = 3.35e12 B/s;
* HBM_BYTES = 80e9 bytes on a card;
* NVLINK_BW = 450e9 B/s each way, to the other cards of its host.

Assumptions of the collective term, the DGX H100 layout: a host holds 8
cards, ranks 8h to 8h + 7; a group whose ranks all lie on one host runs over
NVLink at NVLINK_BW; any other group crosses hosts at NETWORK_BW = 50e9 B/s
a card (one 400 Gb/s NIC per card); a group of one rank moves nothing.  On
the production meshes every axis crosses hosts (``model``: 16 consecutive
ranks; ``data``: a stride of 16; ``pod``: a stride of 256), so every
collective there runs at NETWORK_BW.

Unlike the JAX module, the bytes need no loop scaling: the port's trace is
eager and runs every layer, so ``bytes_per_device`` is its traffic
(``launch/cost_analysis.py``).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod1|pod2] [--json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import OUT_DIR

PEAK_FLOPS = 989e12  # bf16 dense, FLOP/s a card
HBM_BW = 3.35e12  # B/s a card
HBM_BYTES = 80e9  # bytes a card
NVLINK_BW = 450e9  # B/s each way, inside a host
NETWORK_BW = 50e9  # B/s a card across hosts: one 400 Gb/s NIC
HOST_CARDS = 8  # cards a host holds

# Ring-style wire weighting per collective type (bytes crossing a card's
# links per byte of output, the (n-1)/n factors taken as 1; an all-reduce
# is a reduce-scatter and an all-gather), as in the JAX module.
WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

DRYRUN_DIR = str(OUT_DIR)


def link_bw(ranks) -> float:
    """The rate of a group of ``ranks``: NVLink where they share a host."""
    return NVLINK_BW if len({r // HOST_CARDS for r in ranks}) == 1 else NETWORK_BW


def _wire_s(ranks, wire: float) -> float:
    """Seconds for ``wire`` bytes over a group of ``ranks``; a group of one
    rank moves nothing."""
    return 0.0 if len(ranks) == 1 else wire / link_bw(ranks)


def model_flops(arch_name: str, shape_name: str) -> float:
    cfg = get_config(arch_name)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    tokens = shape.global_batch
    return 2.0 * n_active * tokens


def _devices(rec: dict) -> int:
    n_dev = 1
    for d in rec.get("mesh", []):
        n_dev *= d
    return n_dev


def time_terms(rec: dict) -> dict:
    """A dry-run record's three roofline terms (s), the dominant one and
    the bound (their max)."""
    ranks = rec.get("axis_ranks", {})
    wire = {a: sum(WIRE_FACTOR.get(k, 1.0) * v for k, v in by_type.items())
            for a, by_type in rec.get("collective_bytes_by_axis", {}).items()}
    terms = {"compute": rec.get("flops_per_device", 0.0) / PEAK_FLOPS,
             "memory": rec.get("bytes_per_device", 0.0) / HBM_BW,
             "collective": sum(_wire_s(ranks.get(a, range(_devices(rec))), w)
                               for a, w in wire.items())}
    return {"t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
            "t_collective_s": terms["collective"], "t_bound_s": max(terms.values()),
            "dominant": max(terms, key=terms.get), "wire_bytes": sum(wire.values()),
            "links": {a: "nvlink" if link_bw(r) == NVLINK_BW else "network"
                      for a, r in ranks.items()}}


def analyze(rec: dict) -> dict:
    n_dev = _devices(rec)
    terms = time_terms(rec)
    mf = model_flops(rec["arch"], rec["shape"])
    trace_global = rec.get("flops_per_device", 0.0) * n_dev
    step_time = terms["t_bound_s"]
    useful_frac = mf / trace_global if trace_global else 0.0
    # roofline fraction: useful model FLOP/s achieved at the bound, vs peak
    mfu_bound = (mf / n_dev / PEAK_FLOPS) / step_time if step_time else 0.0
    return {
        **rec,
        **terms,
        "model_flops": mf,
        "useful_flop_ratio": useful_frac,
        "roofline_fraction": mfu_bound,
        "peak_gb": rec.get("peak_bytes", 0) / 1e9,
        "fits": rec.get("peak_bytes", 0) <= HBM_BYTES,
    }


def load_all(mesh_tag: str = "pod1") -> list[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(DRYRUN_DIR, f"*__{mesh_tag}.json"))):
        with open(p) as f:
            rec = json.load(f)
        out.append(analyze(rec) if rec.get("ok") else rec)
    return out


def table(records: list[dict]) -> str:
    hdr = ("| arch | shape | mapping | compute s | memory s | collective s | dominant | "
           "args GB/dev | peak GB/dev (of 80) | useful/trace | roofline frac |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for r in records:
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | FAILED: "
                         f"{r.get('error', '')[:60]} |||||||||")
            continue
        args_gb = (r.get("argument_size_in_bytes") or 0) / 1e9
        over = "" if r["fits"] else " (over)"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mapping']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | {r['dominant']} | "
            f"{args_gb:.2f} | {r['peak_gb']:.2f}{over} | {r['useful_flop_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def _half(r: dict) -> list[str]:
    if not r.get("ok"):
        return ["FAILED", r.get("error", "")[:70], "", ""]
    over = "" if r["fits"] else " (over)"
    return [r["mapping"], f"{r['peak_gb']:.1f}{over}",
            f"{r['dominant']} {r['t_bound_s']:.3g}", f"{r['roofline_fraction']:.3f}"]


def table_both(pod1: list[dict], pod2: list[dict]) -> str:
    """One row a cell, the single-pod and the multi-pod mesh side by side."""
    two = {(r["arch"], r["shape"]): r for r in pod2}
    lines = ["| arch | shape | mapping | peak GB/dev (of 80) | dominant, bound s | "
             "roofline frac |", "|" + "---|" * 6]
    for r in pod1:
        q = two.get((r["arch"], r["shape"]), {"error": "no pod2 record"})
        cols = [f"{a} / {b}" if (a or b) else "" for a, b in zip(_half(r), _half(q))]
        lines.append(f"| {r['arch']} | {r['shape']} | " + " | ".join(cols) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod1", help="pod1, pod2, or both (side by side)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    print(f"H100 SXM: {PEAK_FLOPS:.3g} FLOP/s bf16, {HBM_BW:.3g} B/s HBM, "
          f"{HBM_BYTES / 1e9:.0f} GB; links {NVLINK_BW:.3g} B/s inside a host of "
          f"{HOST_CARDS}, {NETWORK_BW:.3g} B/s across hosts")
    if args.mesh == "both":
        print(table_both(load_all("pod1"), load_all("pod2")))
        return
    recs = load_all(args.mesh)
    if args.json:
        print(json.dumps(recs, indent=1))
        return
    print(table(recs))
    ok = [r for r in recs if r.get("ok")]
    if ok:
        worst = min(ok, key=lambda r: r["roofline_fraction"])
        coll_bound = max(ok, key=lambda r: r["t_collective_s"] / max(r["t_compute_s"], 1e-12))
        print(f"\nworst roofline fraction: {worst['arch']} x {worst['shape']} "
              f"({worst['roofline_fraction']:.3f})")
        print(f"most collective-bound: {coll_bound['arch']} x {coll_bound['shape']}")
        over = [f"{r['arch']} x {r['shape']}" for r in ok if not r["fits"]]
        print(f"over {HBM_BYTES / 1e9:.0f} GB a card: {len(over)} of {len(ok)}"
              + (f" ({', '.join(over)})" if over else ""))


if __name__ == "__main__":
    main()
