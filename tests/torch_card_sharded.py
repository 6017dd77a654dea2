"""The port's multi-device path on the card: the SLAM step sharded over a
model axis of ranks (one process and one card each, NCCL, the collectives
inside the captured CUDA graphs) against the unsharded Simulator, and the
VCO kernel's oscillator shards on separate ranks.

    python3 tests/torch_card_sharded.py [--worlds 1,2,4] [--steps 2000]
    python3 tests/torch_card_sharded.py --smoke

Default: for each world size the machine has cards for (1, 2 and 4 by
default; the others are named as not run), bench.py's seed-0 world at
full width (82,280 LIF) for ``--steps`` steps on the ranks, against the
unsharded Simulator on card 0: the spike-flip bounds over the first 300
rows (``chip_smoke.check_first_rows``) and the tracking cosine within
TRACKING_TOL (0.016, phase 34's largest per-seed gap) of the unsharded
run's; the all-reduces a step and their bytes; the sharded VCO scan at
the main path's width, one ``vco_scan`` launch a rank a chunk, against
the unsharded kernel; then ``experiments/tp_scaling.py`` at the same
sizes.  ``--smoke`` (``chip_smoke.py``'s phase 35): the multi-device dry
run, then 300 full-width steps, at world min(4, cards).

Prints one JSON line ``{"mesh": ...}``, then the VCO kernel's launches in
this process (``vco_scan launches: 0``; the ranks count their own).  More
ranks than cards raise.  No JAX is imported.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from sspslam_tpu_torch import bench  # noqa: E402
from sspslam_tpu_torch.experiments.common import (  # noqa: E402
    slam_simulator, slam_world)
from sspslam_tpu_torch.ops import vco_scan  # noqa: E402

TRACKING_TOL = 0.016
VCO_CHUNKS = 2


def build(device, mesh=None):
    """bench.py's seed-0 SLAM world at full width; (sim, probe, space,
    path)."""
    args = bench.parse_args(["--device", "cuda"])
    space = bench.make_space(args)
    world = slam_world(args.world_T, args.n_landmarks, args.seed)
    sim, probe, _ = slam_simulator(
        space, world, pi_n_neurons=args.pi_n_neurons,
        mem_n_neurons=args.mem_n_neurons,
        circonv_n_neurons=args.circonv_n_neurons,
        cleanup_samples=args.cleanup_samples, seed=args.seed, device=device,
        mesh=mesh)
    return sim, probe, space, world[0]


def vco_inputs(d):
    vel = torch.tensor(chip_smoke.traffic()[:VCO_CHUNKS * chip_smoke.CHUNK])
    return vel, torch.zeros((len(vel), d), dtype=torch.float32)


def rank_main(rank, world, device, steps):
    """One rank: the sharded SLAM over ``steps`` steps (graph replay),
    then the sharded VCO scan over VCO_CHUNKS chunks."""
    from sspslam_tpu_torch import FastPathIntegrator
    from sspslam_tpu_torch.parallel import make_mesh, make_sharded_vco_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(world)
    t0 = time.perf_counter()
    sim, probe, space, _ = build(device, mesh)
    build_s = time.perf_counter() - t0
    sim.run_steps(steps)
    sim.sync()
    out = {"trace": sim.data[probe], "stats": sim.mesh_stats(),
           "graphs": sorted(sim._graphs), "build_s": build_s}
    del sim
    fpi = FastPathIntegrator(space, chip_smoke.N_NEURONS,
                             seed=chip_smoke.SEED,
                             chunk_steps=chip_smoke.CHUNK, device=device)
    run = make_sharded_vco_scan(fpi.params, None, chip_smoke.CHUNK,
                                mesh=mesh)
    vel, corr = vco_inputs(fpi.d)
    state, ys, per_chunk = run.initial_state(), [], []
    for c in range(VCO_CHUNKS):
        sl = slice(c * chip_smoke.CHUNK, (c + 1) * chip_smoke.CHUNK)
        before = vco_scan.vco_scan.launches
        state, y = run(state, vel[sl], corr[sl])
        torch.cuda.synchronize(device)
        per_chunk.append(vco_scan.vco_scan.launches - before)
        ys.append(y.cpu().numpy())
    out["vco_trace"] = np.concatenate(ys)
    out["vco_launches_per_chunk"] = per_chunk
    out["oscillators_per_rank"] = int(run.shards[0].bias.shape[1])
    return out


def unsharded(steps):
    """The unsharded Simulator's trace on card 0, tracking cosine, and the
    unsharded VCO kernel's trace over the same chunks."""
    from sspslam_tpu_torch import FastPathIntegrator
    sim, probe, space, path = build("cuda")
    sim.run_steps(steps)
    trace = sim.data[probe]
    del sim
    fpi = FastPathIntegrator(space, chip_smoke.N_NEURONS,
                             seed=chip_smoke.SEED,
                             chunk_steps=chip_smoke.CHUNK, device="cuda")
    vel, corr = vco_inputs(fpi.d)
    state, ys = fpi.initial_state(), []
    for c in range(VCO_CHUNKS):
        sl = slice(c * chip_smoke.CHUNK, (c + 1) * chip_smoke.CHUNK)
        state, y = vco_scan.vco_scan(fpi.params, state, vel[sl].cuda(),
                                     corr[sl].cuda())
        ys.append(y.cpu().numpy())
    return trace, space, path, np.concatenate(ys)


def compare(world, steps, plain, timeout):
    """The sharded run at ``world`` ranks against the unsharded one."""
    from sspslam_tpu_torch.parallel import spawn
    trace0, space, path, vco0 = plain
    t0 = time.perf_counter()
    ranks = spawn(rank_main, world, "cuda", args=(steps,), timeout=timeout)
    seconds = time.perf_counter() - t0
    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        if not np.array_equal(res["trace"], r0["trace"]):
            raise AssertionError(f"world {world}: rank {r}'s rows differ "
                                 f"from rank 0's")
    trace = r0["trace"]
    if not (trace.shape == trace0.shape and np.all(np.isfinite(trace))):
        raise AssertionError(f"world {world}: trace {trace.shape}")
    flips = chip_smoke.check_first_rows(trace, trace0[:chip_smoke.
                                                      REFERENCE_ROWS],
                                        f"sharded over {world} ranks")
    out = {"world": world, "steps": steps, "seconds": seconds,
           "build_s": r0["build_s"], "first_rows": flips,
           "all_reduces_per_step": r0["stats"]["all_reduces"],
           "all_reduce_bytes_per_step": r0["stats"]["bytes"],
           "captured_graph_lengths": r0["graphs"],
           "max_abs_vs_unsharded": float(np.abs(trace - trace0).max())}
    if steps >= 1000:
        cos = chip_smoke.tracking_cosine(space, trace, path)
        cos0 = chip_smoke.tracking_cosine(space, trace0, path)
        out.update(tracking=cos, tracking_unsharded=cos0)
        if not abs(cos - cos0) <= TRACKING_TOL:
            raise AssertionError(f"world {world}: tracking {cos} against "
                                 f"the unsharded {cos0}")
    launches = [res["vco_launches_per_chunk"] for res in ranks]
    if any(n != 1 for per in launches for n in per):
        raise AssertionError(f"world {world}: vco_scan launches a rank a "
                             f"chunk {launches}, not 1")
    diff = np.abs(r0["vco_trace"] - vco0)
    med = float(np.median(diff))
    if not med <= chip_smoke.LONG_MEDIAN_TOL:
        raise AssertionError(f"world {world}: sharded VCO scan vs the "
                             f"unsharded kernel, median {med}")
    out.update(vco_launches_per_rank_per_chunk=launches,
               vco_oscillators_per_rank=r0["oscillators_per_rank"],
               vco_median_vs_unsharded=med,
               vco_max_abs_vs_unsharded=float(diff.max()))
    chip_smoke.log(f"mesh, world {world}: {steps} full-width steps in "
                   f"{seconds:.1f} s (build {r0['build_s']:.1f} s); "
                   f"{out['all_reduces_per_step']} all-reduces a step, "
                   f"{out['all_reduce_bytes_per_step']} bytes; first rows "
                   f"median {flips['median']:.2e}, q80 {flips['q80']:.2e}, "
                   f"peak {flips['peak']:.2e}; tracking "
                   f"{out.get('tracking')} vs {out.get('tracking_unsharded')}"
                   f"; vco_scan launches a rank a chunk {launches}, "
                   f"median vs unsharded {med:.2e}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worlds", default="1,2,4")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_card_sharded: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = torch.cuda.device_count()
    result = {"cards": cards, "nvidia_smi": chip_smoke.nvidia_smi()}
    if args.smoke:
        from sspslam_tpu_torch.parallel import dryrun
        world = min(4, cards)
        result["dryrun"] = dryrun.main(["--world", str(world)])
        worlds, steps = [world], chip_smoke.REFERENCE_ROWS
    else:
        asked = [int(x) for x in args.worlds.split(",")]
        worlds = [w for w in asked if w <= cards]
        result["not_run"] = [w for w in asked if w > cards]
        steps = args.steps
    plain = unsharded(steps)
    result["runs"] = [compare(w, steps, plain, args.timeout)
                      for w in worlds]
    if not args.smoke:
        from sspslam_tpu_torch.experiments import tp_scaling
        result["tp_scaling"] = tp_scaling.main(
            ["--mesh-sizes", ",".join(map(str, worlds))])
    print(json.dumps({"mesh": result}), flush=True)
    print(f"vco_scan launches: {vco_scan.vco_scan.launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
