"""Where a ``chip_smoke.py`` run spends its time, phase by phase, for one or
more runs side by side.

    python tools/smoke_phase_times.py PARENT.txt TREE.txt [--json OUT]

Each file is a run's standard output.  Every JSON record the smoke prints
carries ``t_s``, the seconds since the script started, taken as the record
is printed.  A segment is a run of consecutive records of one ``phase``; its
time is its last ``t_s`` less the previous segment's last ``t_s`` (the
first segment counts from 0, so it holds imports and the kernels' build).
Segments are matched across runs by phase name and occurrence.  The table
prints each segment's seconds in every run, the difference of the last run
from the first, and the totals.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def segments(path: Path) -> list[tuple[str, float]]:
    """(phase#occurrence, seconds) for each segment of one run, in order."""
    out, seen, last_t, cur = [], {}, 0.0, None
    for line in path.read_text().splitlines():
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        phase, t = rec.get("phase"), rec.get("t_s")
        if phase is None or t is None:
            continue
        if cur is not None and cur[0] == phase:
            cur[2] = t
            continue
        if cur is not None:
            out.append((cur[1], cur[2] - last_t))
            last_t = cur[2]
        seen[phase] = seen.get(phase, 0) + 1
        cur = [phase, f"{phase}#{seen[phase]}", t]
    if cur is not None:
        out.append((cur[1], cur[2] - last_t))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", type=Path)
    ap.add_argument("--json", type=Path, help="also write the table here as JSON")
    args = ap.parse_args(argv)
    runs = [dict(segments(p)) for p in args.runs]
    order = []
    for r in runs:
        order += [k for k in r if k not in order]
    rows = [{"segment": k, "s": [r.get(k) for r in runs]} for k in order]
    width = max(len(k) for k in order)
    print("segment".ljust(width), *(p.name[:12].rjust(12) for p in args.runs), "last-first")
    for row in rows:
        s = row["s"]
        diff = (s[-1] - s[0]) if None not in (s[0], s[-1]) else None
        print(row["segment"].ljust(width),
              *("-".rjust(12) if v is None else f"{v:12.1f}" for v in s),
              "" if diff is None else f"{diff:+10.1f}")
    totals = [sum(r.values()) for r in runs]
    print("total".ljust(width), *(f"{v:12.1f}" for v in totals), f"{totals[-1] - totals[0]:+10.1f}")
    if args.json:
        args.json.write_text(json.dumps({"runs": [str(p) for p in args.runs], "rows": rows,
                                         "totals": totals}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
