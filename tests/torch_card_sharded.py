"""The port's multi-device path on the card: the SLAM step sharded over a
model axis of ranks (one process and one card each, NCCL, the collectives
inside the captured CUDA graphs) against the unsharded Simulator, its
sharded serving bundle served on the ranks against the live run, and the
VCO kernel's oscillator shards on separate ranks.

    python3 tests/torch_card_sharded.py [--worlds 1,2,4] [--steps 2000]
    python3 tests/torch_card_sharded.py --smoke

Default: for each world size the machine has cards for (1, 2 and 4 by
default; the others are named as not run), bench.py's seed-0 world at
full width (82,280 LIF) for ``--steps`` steps on the ranks, against the
unsharded Simulator on card 0: the spike-flip bounds over the first 300
rows (``chip_smoke.check_first_rows``) and the tracking cosine within
TRACKING_TOL (0.016, phase 34's largest per-seed gap) of the unsharded
run's; the all-reduces a step and their bytes; a serving bundle saved
from the sharded Simulator's fresh state before its live run
(``save_bundle``, one program a model coordinate), served by
``ServingModel`` on every rank in segments of 200 steps: its
rows within SERVED_TOL (1e-6, phase 25's bound) of the live rows on
every rank, each program's all-reduces equal to the live step's, the
export's seconds and megabytes, served and live ms a segment (the median
of the segments after the first, which captures the graphs), 0 VCO
kernel launches in the build, the live run and the serving; the sharded
VCO scan at the main path's width, one ``vco_scan`` launch a rank a
chunk, against the unsharded kernel; then, on four cards, a (2, 2)
("data", "model") mesh (DP_TP: its data-1 ranks serve a program that
names another process group than theirs; rows and bundle only) and
``experiments/tp_scaling.py`` at the worlds' sizes.  ``--smoke``
(``chip_smoke.py``'s phase 35): the multi-device dry run with its bundle
step, then 300 full-width steps and their bundle in segments of 100, at
world min(4, cards).

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
from sspslam_tpu_torch.utils import profiling  # noqa: E402

TRACKING_TOL = 0.016
SERVED_TOL = 1e-6
VCO_CHUNKS = 2
DP_TP = (2, 2)


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


def rank_main(rank, world, device, steps, seg, bundle, shape=None):
    """One rank: the sharded SLAM, its serving bundle saved into
    ``bundle`` from the fresh state, ``steps`` live steps (graph replay)
    and the same steps served from the bundle, both in segments of
    ``seg``; then (on a 1-D model axis) the sharded VCO scan over
    VCO_CHUNKS chunks.  ``shape``: a (data, model) mesh."""
    from sspslam_tpu_torch import FastPathIntegrator
    from sspslam_tpu_torch.nef import ServingModel, save_bundle
    from sspslam_tpu_torch.parallel import make_mesh, make_sharded_vco_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = (make_mesh(world) if shape is None
            else make_mesh(world, ("data", "model"), shape))
    launches0 = profiling.counter("vco_scan.launches")
    t0 = time.perf_counter()
    sim, probe, space, _ = build(device, mesh)
    build_s = time.perf_counter() - t0
    sim.preload_inputs(steps)
    xs = sim._preloaded.copy()
    t0 = time.perf_counter()
    save_bundle(sim, bundle, segment_steps=seg)
    export_s = time.perf_counter() - t0
    live_ms = []
    for _ in range(0, steps, seg):
        t0 = time.perf_counter()
        sim.run_steps(seg, segment_steps=seg)
        sim.sync()
        live_ms.append(1e3 * (time.perf_counter() - t0))
    trace = sim.data[probe]
    out = {"trace": trace, "stats": sim.mesh_stats(),
           "graphs": sorted(sim.loop.graphs), "build_s": build_s,
           "export_s": export_s, "live_ms": live_ms}
    label = next(d["label"] for d in _meta(bundle)["probes"]
                 if d["index"] == next(bp.index for bp in sim.model.probes
                                       if bp.obj is probe))
    del sim
    m = ServingModel(bundle, device=device)
    served, served_ms = [], []
    for a in range(0, steps, seg):
        t0 = time.perf_counter()
        served.append(m.run(xs[a:a + seg])[label])
        served_ms.append(1e3 * (time.perf_counter() - t0))
    served = np.concatenate(served)
    mm = m.meta["mesh"]
    out.update(slam_vco_launches=(profiling.counter("vco_scan.launches")
                                  - launches0),
               served_max_abs=float(np.abs(served - trace).max()),
               served_ms=served_ms, programs=len(mm["programs"]),
               program_all_reduces=mm["all_reduces_per_step"],
               recorded_group=mm["group_name"],
               serving_group=m.mesh.group(mm["axis"]).group_name,
               bundle_mb=sum(f.stat().st_size for f in Path(bundle).iterdir())
               / 1e6)
    del m
    if shape is not None:
        return out
    fpi = FastPathIntegrator(space, chip_smoke.N_NEURONS,
                             seed=chip_smoke.SEED,
                             chunk_steps=chip_smoke.CHUNK, device=device)
    run = make_sharded_vco_scan(fpi.params, None, chip_smoke.CHUNK,
                                mesh=mesh)
    vel, corr = vco_inputs(fpi.d)
    state, ys, per_chunk = run.initial_state(), [], []
    for c in range(VCO_CHUNKS):
        sl = slice(c * chip_smoke.CHUNK, (c + 1) * chip_smoke.CHUNK)
        before = profiling.counter("vco_scan.launches")
        state, y = run(state, vel[sl], corr[sl])
        torch.cuda.synchronize(device)
        per_chunk.append(profiling.counter("vco_scan.launches") - before)
        ys.append(y.cpu().numpy())
    out["vco_trace"] = np.concatenate(ys)
    out["vco_launches_per_chunk"] = per_chunk
    out["oscillators_per_rank"] = int(run.shards[0].bias.shape[1])
    return out


def _meta(bundle):
    with open(Path(bundle) / "meta.json") as f:
        return json.load(f)


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


def compare(world, steps, seg, plain, timeout, shape=None):
    """The sharded run at ``world`` ranks (a ("data", "model") mesh of
    ``shape``) against the unsharded one, and its bundle served against
    it on every rank."""
    import shutil
    import tempfile
    from sspslam_tpu_torch.parallel import spawn
    trace0, space, path, vco0 = plain
    bundle = tempfile.mkdtemp(prefix="sspslam_card_bundle_")
    t0 = time.perf_counter()
    try:
        ranks = spawn(rank_main, world, "cuda",
                      args=(steps, seg, bundle, shape), timeout=timeout)
    finally:
        shutil.rmtree(bundle, ignore_errors=True)
    seconds = time.perf_counter() - t0
    what = f"world {world}" + (f" mesh {shape}" if shape else "")
    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        if not np.array_equal(res["trace"], r0["trace"]):
            raise AssertionError(f"{what}: rank {r}'s rows differ from "
                                 f"rank 0's")
    trace = r0["trace"]
    if not (trace.shape == trace0.shape and np.all(np.isfinite(trace))):
        raise AssertionError(f"{what}: trace {trace.shape}")
    flips = chip_smoke.check_first_rows(trace, trace0[:chip_smoke.
                                                      REFERENCE_ROWS],
                                        f"sharded, {what}")
    n_model = world if shape is None else shape[1]
    served = [res["served_max_abs"] for res in ranks]
    live_ar = r0["stats"]["all_reduces"]
    slam_launches = [res["slam_vco_launches"] for res in ranks]
    if any(slam_launches):
        raise AssertionError(f"{what}: the live and served SLAM launched "
                             f"vco_scan {slam_launches} times")
    if not (max(served) <= SERVED_TOL and r0["programs"] == n_model
            and all(res["program_all_reduces"] == live_ar
                    for res in ranks)):
        raise AssertionError(f"{what}: served vs live max-abs {served} "
                             f"(bound {SERVED_TOL}), {r0['programs']} "
                             f"programs for a model axis of {n_model}, "
                             f"all-reduces a program "
                             f"{[res['program_all_reduces'] for res in ranks]}"
                             f" against the live step's {live_ar}")
    live_ms = float(np.median(r0["live_ms"][1:] or r0["live_ms"]))
    served_ms = float(np.median(r0["served_ms"][1:] or r0["served_ms"]))
    out = {"world": world, "mesh_shape": shape, "steps": steps,
           "seconds": seconds, "build_s": r0["build_s"],
           "first_rows": flips, "all_reduces_per_step": live_ar,
           "all_reduce_bytes_per_step": r0["stats"]["bytes"],
           "captured_graph_lengths": r0["graphs"],
           "max_abs_vs_unsharded": float(np.abs(trace - trace0).max()),
           "bundle": {"programs": r0["programs"],
                      "program_all_reduces": r0["program_all_reduces"],
                      "export_s": r0["export_s"], "mb": r0["bundle_mb"],
                      "served_max_abs_vs_live": served,
                      "segment_steps": seg, "live_ms_per_segment": live_ms,
                      "served_ms_per_segment": served_ms,
                      "live_steps_per_s": 1e3 * seg / live_ms,
                      "served_steps_per_s": 1e3 * seg / served_ms,
                      "vco_scan_launches": slam_launches,
                      "groups": [(res["recorded_group"],
                                  res["serving_group"]) for res in ranks]}}
    if steps >= 1000:
        cos = chip_smoke.tracking_cosine(space, trace, path)
        cos0 = chip_smoke.tracking_cosine(space, trace0, path)
        out.update(tracking=cos, tracking_unsharded=cos0)
        if not abs(cos - cos0) <= TRACKING_TOL:
            raise AssertionError(f"{what}: tracking {cos} against the "
                                 f"unsharded {cos0}")
    b = out["bundle"]
    bundle_log = (f"bundle: {b['programs']} programs, {b['mb']:.2f} MB, "
                  f"vco_scan launches live and served {slam_launches}, "
                  f"export {b['export_s']:.1f} s, served vs live max-abs "
                  f"{max(served):.2e}, {seg}-step segments served "
                  f"{served_ms:.2f} ms ({b['served_steps_per_s']:.1f} "
                  f"steps/s) vs live {live_ms:.2f} ms "
                  f"({b['live_steps_per_s']:.1f} steps/s)")
    if shape is not None:
        chip_smoke.log(f"mesh, {what}: {steps} full-width steps in "
                       f"{seconds:.1f} s; first rows median "
                       f"{flips['median']:.2e}; groups recorded / serving "
                       f"{b['groups']}; {bundle_log}")
        return out
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
                   f"median vs unsharded {med:.2e}; {bundle_log}")
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
        worlds, steps, seg = [world], chip_smoke.REFERENCE_ROWS, 100
        shapes = []
    else:
        asked = [int(x) for x in args.worlds.split(",")]
        worlds = [w for w in asked if w <= cards]
        result["not_run"] = [w for w in asked if w > cards]
        steps, seg = args.steps, 200
        shapes = [DP_TP] if int(np.prod(DP_TP)) <= cards else []
        if not shapes:
            result["not_run"].append(list(DP_TP))
    if steps % seg:
        raise SystemExit(f"--steps {steps} is not a multiple of the "
                         f"segment {seg}")
    plain = unsharded(steps)
    result["runs"] = [compare(w, steps, seg, plain, args.timeout)
                      for w in worlds]
    result["runs"] += [compare(int(np.prod(sh)), steps, seg, plain,
                               args.timeout, sh) for sh in shapes]
    if not args.smoke:
        from sspslam_tpu_torch.experiments import tp_scaling
        result["tp_scaling"] = tp_scaling.main(
            ["--mesh-sizes", ",".join(map(str, worlds))])
    print(json.dumps({"mesh": result}), flush=True)
    print(f"vco_scan launches: {profiling.counter('vco_scan.launches')}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
