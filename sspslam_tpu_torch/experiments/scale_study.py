"""Throughput against model scale on the port: the flags, rows and table
of the JAX package's ``experiments/scale_study.py``, with ``--device``
(default ``cuda``) in place of ``--cpu``.

Each row builds ``bench.py --model slam``'s network and world (the port's
:func:`common.slam_simulator` on :func:`common.slam_world`) at one
ssp_dim, with the populations scaled as the reference CLI's defaults
relate to d = 97: memory 10 d, 800 neurons per VCO, 100 per circular-
convolution dimension; times it in float32 and with bf16 matmul inputs;
and counts its MFLOP per step from the built shapes
(:func:`utils.profiling.model_utilization_summary`).

    python -m sspslam_tpu_torch.experiments.scale_study \
        [--dims 97,193,385,769] [--steps 10000] [--device cpu]

Prints a markdown table (and one JSON line per row on stderr).
"""

import argparse
import json
import sys
import time

import numpy as np

from ..sspspace import HexagonalSSPSpace
from ..utils.profiling import model_utilization_summary
from .common import slam_simulator, slam_world


def measure(d, steps, seg, bf16, seed=0, reps=3, device="cuda"):
    """One row: build, first-segment (capture) and best-of-``reps``
    timings of the flagship SLAM's network at ssp_dim ``d``."""
    t0 = time.time()
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=d, seed=seed, length_scale=0.3,
                              domain_bounds=bounds)
    sim, _, _ = slam_simulator(
        space, slam_world(14.0, 10, seed), pi_n_neurons=800,
        mem_n_neurons=10 * d, circonv_n_neurons=100, cleanup_samples=100,
        seed=seed, device=device, matmul_dtype="bf16" if bf16 else None)
    build_s = time.time() - t0
    n_neurons = sum((be.k * be.n if be.batched else be.n)
                    for be in sim.model.ensembles)

    # cover the warm-up and ALL reps: the reps continue the simulation
    sim.preload_inputs(reps * steps + seg)
    t0 = time.time()
    sim.run_steps(seg, segment_steps=seg)
    sim.sync()
    compile_s = time.time() - t0

    best = 0.0
    for _ in range(reps):
        t0 = time.time()
        sim.run_steps(steps, segment_steps=seg)
        sim.sync()
        best = max(best, steps / (time.time() - t0))
    flops = float(sum(r["flops_per_step"]
                      for r in model_utilization_summary(sim.model)))
    return {"d": space.ssp_dim, "neurons": n_neurons, "bf16": bf16,
            "build_s": round(build_s, 1), "compile_s": round(compile_s, 1),
            "steps_per_s": round(best, 0),
            "us_per_step": round(1e6 / best, 2),
            "mflop_per_step": round(flops / 1e6, 2)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", default="97,193,385,769")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--segment-steps", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--f32-only", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the simulation runs on (cuda | cpu)")
    args = ap.parse_args(argv)

    rows = []
    for d in [int(x) for x in args.dims.split(",")]:
        for bf16 in ([False] if args.f32_only else [False, True]):
            r = measure(d, args.steps, args.segment_steps, bf16,
                        reps=args.reps, device=args.device)
            rows.append(r)
            print(json.dumps(r), file=sys.stderr, flush=True)

    print("| d | LIF neurons | params dtype | MFLOP/step | steps/s "
          "(best of reps, synced) | us/step |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['d']} | {r['neurons']:,} | "
              f"{'bf16' if r['bf16'] else 'f32'} | {r['mflop_per_step']} | "
              f"{r['steps_per_s']:,.0f} | {r['us_per_step']} |")
    return rows


if __name__ == "__main__":
    main()
