"""The control of each cell's comparison, on the card at the cell's size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 3]

For each seed it runs the cell as a benchmark run does (set-up, a window
of ``--seconds``, the program's outputs for the check), then reads every
compared number twice: for the program's outputs, and for the control's,
the reference computed with TF32 operands (the precision below the
float32, TF32-off contractions the configurations state) put in the
program's place.  One JSON line per seed; the last line holds, per
number, the largest program reading (the lower reading of its limit) and
the smallest control reading (the upper one).  The limits in the mix
files were set from these lines (PERF.md).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import cell, core  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device,
             cfg=None, mix=None, bench=None) -> dict:
    """The program's and the control's compared numbers for one seed."""
    bench = bench or core.load_benchmark()
    c, _, cfg0, mix0 = core.cell_files(bench, workload)
    cfg, mix = cfg or cfg0, mix or mix0
    ctx, entry, out, _ = cell.drive(bench, c, cfg, mix, seed=seed,
                                    seconds=seconds, trace=False,
                                    device=device, t_start=time.time())
    r = entry.readings(cfg, mix, seed, device, out)
    return {"seed": seed, "program": r["program"][0],
            "control": r["control"][0], "where": r["program"][1],
            "limits": mix["limits"]}


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        core.log("the control runs on the card")
        return 2
    rows = []
    for s in args.seeds.split(","):
        rows.append(readings(args.workload, int(s), args.seconds,
                             torch.device("cuda", 0)))
        print(json.dumps(rows[-1]), flush=True)
    names = rows[0]["program"].keys()
    print(json.dumps({
        "workload": args.workload,
        "lower": {n: max(r["program"][n] for r in rows) for n in names},
        "upper": {n: min(r["control"][n] for r in rows) for n in names}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
