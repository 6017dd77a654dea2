"""Serving-bundle throughput: the deployment artifact against the live
engine, on the port.

Port of the JAX package's ``experiments/serving_probe.py``: steps/s of
``ServingModel.run`` on the flagship SLAM model (``bench.py --model slam``'s
world and widths), the per-segment host input upload and the final probe
pull included, beside the live Simulator's steps/s on a device-resident
table, from the same process.  The bundle is exported after the live
engine's warm-up run, so it ships the learned state.

    python -m sspslam_tpu_torch.experiments.serving_probe \\
        [--timed-steps 50000] [--device cuda]

Prints one JSON line.  ``--device`` (default ``cuda``) replaces the JAX
CLI's ``--cpu``; ``--scan-unroll`` is not carried (ROADMAP.md, "do not
carry").
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..nef import ServingModel, save_bundle
from ..sspspace import HexagonalSSPSpace
from .common import slam_simulator, slam_world


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=970)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--n-landmarks", type=int, default=10)
    ap.add_argument("--cleanup-samples", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world-T", type=float, default=14.0)
    ap.add_argument("--segment-steps", type=int, default=5000)
    ap.add_argument("--timed-steps", type=int, default=50000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--keep-bundle", default=None,
                    help="directory to keep the bundle in (default: temp)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine and the bundle run on "
                         "(cuda | cpu)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    log(f"device: {torch.cuda.get_device_name(device)}"
        if device.type == "cuda" else f"device: {device}")
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=args.seed,
                              length_scale=0.3, domain_bounds=bounds)
    world = slam_world(args.world_T, args.n_landmarks, args.seed)
    sim, probe, build_s = slam_simulator(
        space, world, matmul_dtype="bf16" if args.bf16 else None,
        pi_n_neurons=args.pi_n_neurons, mem_n_neurons=args.mem_n_neurons,
        circonv_n_neurons=args.circonv_n_neurons,
        cleanup_samples=args.cleanup_samples, seed=args.seed, device=device)
    log(f"build: {build_s:.1f}s")
    seg = args.segment_steps
    n_timed = max(seg, args.timed_steps // seg * seg)

    # live engine numbers (device-resident table, the bench.py protocol)
    sim.preload_inputs(seg + n_timed)
    t0 = time.time()
    sim.run_steps(seg, segment_steps=seg)
    sim.sync()
    log(f"live compile+warmup: {time.time() - t0:.1f}s")
    live_rates = []
    for _ in range(args.reps):
        t0 = time.time()
        sim.run_steps(n_timed, segment_steps=seg)
        sim.sync()
        live_rates.append(n_timed / (time.time() - t0))
        sim._preload_start = sim.n_steps - seg
    live_sps = float(np.median(live_rates))
    log(f"live engine: {live_sps:.0f} steps/s "
        f"(range {min(live_rates):.0f}-{max(live_rates):.0f})")

    # export AFTER the warm run: the bundle ships the learned state
    out_dir = args.keep_bundle or tempfile.mkdtemp(prefix="sspslam_bundle_")
    t0 = time.time()
    save_bundle(sim, out_dir, segment_steps=seg)
    export_s = time.time() - t0
    bundle_mb = sum(
        os.path.getsize(os.path.join(out_dir, f))
        for f in os.listdir(out_dir)) / 1e6
    log(f"export: {export_s:.1f}s, bundle {bundle_mb:.1f} MB -> {out_dir}")

    m = ServingModel(out_dir, device=device)
    # a serving worker feeds host-resident input rows each call: tabulate
    # one timed block's worth (replayed per rep)
    xs = np.asarray(sim._pack_cols(sim._tabulate_inputs(n_timed)),
                    np.float32)[:n_timed]
    t0 = time.time()
    m.run(xs[:seg])
    log(f"serving load+first-call: {time.time() - t0:.1f}s")
    serve_rates = []
    for _ in range(args.reps):
        t0 = time.time()
        out = m.run(xs)
        # m.run's final concatenate is the device->host pull (a barrier)
        serve_rates.append(n_timed / (time.time() - t0))
    serve_sps = float(np.median(serve_rates))
    log(f"serving bundle: {serve_sps:.0f} steps/s "
        f"(range {min(serve_rates):.0f}-{max(serve_rates):.0f})")
    probe_label = next(iter(out))
    if out[probe_label].shape[0] != n_timed:
        raise RuntimeError(f"served {out[probe_label].shape[0]} rows, not "
                           f"{n_timed}")

    if args.keep_bundle is None:
        shutil.rmtree(out_dir, ignore_errors=True)

    print(json.dumps({
        "metric": "serving bundle throughput, flagship SLAM "
                  f"(ssp_dim={args.ssp_dim}, segment={seg}; includes "
                  "per-segment host input upload + probe pull)",
        "value": round(serve_sps, 1), "unit": "steps/s",
        "vs_baseline": None,
        "live_engine_steps_per_s": round(live_sps, 1),
        "serving_over_live": round(serve_sps / live_sps, 3),
        "bundle_mb": round(bundle_mb, 1),
        "export_s": round(export_s, 1),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
    }))


if __name__ == "__main__":
    main()
