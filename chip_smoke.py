"""Smoke test of the PyTorch / CUDA port on one Hopper GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and imports nothing of JAX or of the JAX package.
Phases (each raises on failure, so the script exits non-zero and prints no
result line):

1. device: the card's name and power limit; TF32 off for matmuls and
   convolutions, so float32 comparisons are float32;
2. build: compiles ``sspslam_tpu_torch/csrc/vco_scan.cu`` for sm_90a;
3. kernel check, for every cluster size C the kernel is built for (CTAs
   per oscillator): at the path integrator's full width (ssp_dim 97 ->
   k = 49 oscillators, 800 LIF neurons each) the VCO-bank kernel against
   its plain PyTorch version on the same params and inputs: 40 steps to
   max-abs <= 2e-4, then a 2,000-step chunk and the main path's first
   10,000-step chunk to median |diff| <= 2e-3 (single spike flips grow
   with the step count, so the long chunks bound the median); then 40
   steps at 48, 300 and 2,000 neurons per oscillator, which run the
   kernel's other neurons-per-thread variants.  The plain version's run
   of the main path's first chunk also counts its spikes, which set the
   kernel's bound (``bound_ms``);
4. cluster sweep: the kernel's time per 10,000-step chunk for each C in
   turns (1, 4, 4, 1) at full width, at 32 neurons per oscillator (the
   per-step floor: exchange and barrier latency with almost no neuron
   work), at the 3-D configurations of ``experiments/scaled_slam.py``
   (ssp_dim 201 and 801 -> k = 101 and 401, 800 LIF each) and at the
   first k oscillators of those builds for k on either side of the edges
   that ``_cluster_size`` and the waves of resident clusters set, each
   first held to the plain version over 40 steps; the card's clocks and
   power are sampled over the sweep;
5. main path: ``FastPathIntegrator`` driven with ``bench.py --model
   pi-fast``'s traffic (one 10,000-step warm-up chunk, then 50,000 timed
   steps) at the C the wrapper picks, with the card's clocks and power
   read just before and just after the timed window; the kernel's launch
   count over that run must be > 0, and the warm-up chunk's trace must
   equal the direct launch of phase 3 and agree with the plain version's
   trace of the same chunk (median |diff| <= 2e-3);
6. whole run: the same 60,000 steps through the kernel at the other C; at
   every chunk end the two decoded positions must lie within 0.1 of each
   other (a third of the length scale 0.3);
7. accuracy: the constant-velocity integration test at full width (decode
   error < 0.25 after 800 steps);
8. the generic engine: ``nef.Simulator`` at full width on ``bench.py
   --model pi``'s traffic (the same velocities as phase 5, PathIntegration
   built from the same seed, LIF): its CUDA-graph replay against its eager
   step over the first 2,000 steps (max-abs <= 1e-6), CUDA kernels per
   step from one ``torch.profiler`` pass over 100 eager steps (and the
   device's busy share over 100 replayed steps), steps/s for graphs of
   U = 1, 10 and 100 steps and for eager stepping (one 10,000-step warm-up
   segment, then 50,000 timed steps each), every U's trace equal to the
   first's, and the decoded positions of the Simulator's trace and the fast
   path's trace of phase 5 within 0.1 of each other at every 10,000-step
   boundary.  This path launches no hand-written kernel (the JAX engine
   reaches no Pallas kernel); the VCO kernel's count over it must stay 0.
   Then the Simulator's bookkeeping through graphs against the CPU's eager
   stepping on a small PES network (segment remainders, sparse snapshots,
   thinning, streamed and preloaded inputs, a learning rate changed in
   place, a checkpoint of the card's run continued on the CPU), within
   1e-4;
9. the constant-velocity accuracy gate through the Simulator at full width
   (decode error < 0.25 after 800 steps);
10. ``python -m sspslam_tpu_torch.experiments.run_pathint`` at its defaults
   (T = 20 s, ssp_dim 97, 800 LIF per VCO) as a subprocess: it must exit 0
   and print finite errors (printed, not gated: path integration alone
   drifts);
11. SLAM: ``SLAMNetwork`` at full width (82,280 LIF neurons: ssp_dim 97,
   800 per VCO, memory 970, 100 per circular-convolution dimension, clean-up
   over 100 x 100 samples in bf16) on ``bench.py --model slam``'s traffic
   (the 14 s world, 10 landmarks, view radius 0.8, the single-nearest
   adapter) through the Simulator: build time and resource summary; graph
   replay against the eager step over 2,000 steps (max-abs <= 1e-6);
   kernels per step from one profiler pass; the tracking cosine over the
   last quarter of the world from one run of its 14,000 steps (>= 0.93,
   bench.py's gate); the gate's hoisted ``shift_rate`` set to 0 in place
   changes the next replay with no new capture, and the replay equals the
   eager step at 0; steps/s over 50,000 timed steps after one 10,000-step
   warm-up segment (inputs past the world repeat its last row), the card's
   clocks and power read just before and after;
12. ``SLAMNetwork(gate_mode="auto_recovery", anchor=True)`` at the same
   width with 3 surveyed landmarks: graph replay against eager over 2,000
   steps (max-abs <= 1e-6) — the stateful gate and its in-step bind /
   unbind inside a captured graph.  Neither SLAM path launches the VCO
   kernel (count 0), as the JAX package's SLAMNetwork reaches no Pallas
   kernel;
13. ``python -m sspslam_tpu_torch.experiments.run_slam --T 20`` at its
   default widths as a subprocess: exit 0 and finite errors (printed, not
   gated).

The last five lines of standard output are one JSON object of the
Simulator's numbers, one of the SLAM numbers, the card's name and power
limit, one JSON object describing the kernel, and the result line.

To compare the kernel of two checkouts on one card, time each in turns
within one command (the other commit unpacked into a git-ignored
directory, e.g. ``git archive <commit> | tar -x -C build/parent``):

    for r in build/parent . . build/parent; do
        python3 chip_smoke.py --time "$r"; done

``--time ROOT`` imports ``sspslam_tpu_torch`` from ROOT, times its
``vco_scan`` at the cluster size it picks on the main path's first chunk
and prints one JSON line; it runs none of the phases above.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SSP_DIM = 97
N_NEURONS = 800
FLOOR_NEURONS = 32
CHUNK = 10_000
TIMED = 50_000
SEED = 0
SHORT, LONG = 40, 2_000
SHORT_TOL = 2e-4      # max-abs over 40 steps (tests/test_pallas.py bound)
LONG_MEDIAN_TOL = 2e-3  # median |diff| over one 2,000- or 10,000-step chunk
DRIFT_TOL = 0.1       # decoded-position difference, two kernels, whole run
ACCURACY_TOL = 0.25   # decode error after 800 steps at constant velocity
GRAPH_UNITS = (1, 10, 100)  # steps per captured CUDA graph, timed in turn
REPLAY_TOL = 1e-6     # graph replay vs eager step, max-abs over LONG steps
PROFILE_STEPS = 100
# bench.py --model slam: the 14 s world, 10 landmarks, view radius 0.8; the
# anchor phase surveys the first 3 landmarks; the tracking gate is bench.py's
WORLD_STEPS = 14_000
SLAM_LANDMARKS = 10
VIEW_RAD = 0.8
ANCHORS = 3
TRACKING_GATE = 0.93
SHIFT_STEPS = 1_000   # steps replayed per setting of a hoisted threshold
SWEEP = (1, 4, 4, 1)
SWEEP_REPEATS = 3
TIME_REPEATS = 5
# The sweep's widths: (name, domain dim, ssp_dim, neurons per oscillator,
# oscillators).  None takes the build's own k; a number takes the first k
# oscillators of the build: on either side of k = 62, where the wrapper's
# choice of C changes on 132 SMs, and of where a wave of resident clusters
# ends; and one point at which that choice is not the faster (PERF.md).
SWEEP_WIDTHS = (
    ("full width", 2, SSP_DIM, N_NEURONS, None),
    ("floor", 2, SSP_DIM, FLOOR_NEURONS, None),
    ("3-D ssp_dim 201, first 62", 3, 201, N_NEURONS, 62),
    ("3-D ssp_dim 201, first 63", 3, 201, N_NEURONS, 63),
    ("3-D ssp_dim 201, n = 400, first 66", 3, 201, 400, 66),
    ("3-D ssp_dim 201", 3, 201, N_NEURONS, None),
    ("3-D ssp_dim 801", 3, 801, N_NEURONS, None),
    *((f"3-D ssp_dim 801, first {k}", 3, 801, N_NEURONS, k)
      for k in (124, 125, 132, 133, 264, 265)),
)

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): float32
# outside the tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# The float32 operations the VCO bank needs (an FMA is two; a division,
# expm1f or log1pf one; compares, selects and min/max are not counted).
# Every neuron and step: the currents 6, the voltage 3, the refractory
# clock 1.
FLOP_NEURON = 10
# Each spike: the spike time (J - 1, volt - 1, the division, log1pf and
# its FMA, + tau_ref) 7; the one step after it whose decay factor is not a
# constant (dt - refr, the division, expm1f) 3; its five decoder values
# added to the decodes 5 (a silent neuron adds nothing).
FLOP_SPIKE = 15
# Every oscillator and step: the three inputs 4, five filters 15.
FLOP_OSC = 19


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query="name,power.limit") -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


class ClockSampler:
    """nvidia-smi's SM clock, power draw and limit, and temperature every
    200 ms while the block runs; the child process is stopped on exit."""

    QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.QUERY}",
             "--format=csv,noheader", "-lms", "200"],
            stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.lines = [line for line in out.splitlines() if line.strip()]
        return False

    def summary(self) -> str:
        if not self.lines:
            return "no samples"
        cols = [[c.strip() for c in line.split(",")] for line in self.lines]
        clocks = [c[0] for c in cols]
        draws = [c[1] for c in cols]
        return (f"{len(cols)} samples ({self.QUERY}): SM clock "
                f"{min(clocks)}..{max(clocks)}, power draw "
                f"{min(draws)}..{max(draws)}, limit {cols[0][2]}, "
                f"temperature {cols[-1][3]} C")


def make_space(space_cls, ssp_dim=SSP_DIM, dim=2):
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (dim, 1))
    return space_cls(dim, ssp_dim=ssp_dim, seed=SEED, length_scale=0.3,
                     domain_bounds=bounds)


def cuda_ms(fn, repeats=1):
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        result = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats, result


def traffic(dim=2):
    """bench.py --model pi-fast's velocities: warm-up chunk, then timed."""
    rng = np.random.default_rng(SEED)
    return (0.02 * rng.normal(size=(CHUNK + TIMED, dim))).astype(np.float32)


def bound_ms(n, k, d, N, T, spikes):
    """The least time of one ``vco_scan`` call (kernel and output
    projection) on the card, for a chunk whose neurons spike ``spikes``
    times: its float32 operations over PEAK_F32 and its bytes (each input
    read once, each output written once) over PEAK_BYTES, whichever is
    larger; returns (ms, "operations"|"bytes")."""
    flop = (T * k * (n * FLOP_NEURON + FLOP_OSC) + spikes * FLOP_SPIKE
            + 2 * T * k * (2 * d + N)      # the input projections
            + 2 * T * 2 * k * d)           # rows @ [ts0T; ts1T]
    floats_in = (9 * n * k + k             # neuron params, dc_mask
                 + (2 * d + N) * k         # tf0T, tf1T, velT_T
                 + 2 * k * d               # ts0T, ts1T
                 + T * (N + d)             # vel, corr
                 + 2 * n * k + 5 * k)      # state
    floats_out = T * d + 2 * n * k + 5 * k  # SSP trace, state
    t_ops = flop / PEAK_F32 * 1e3
    t_bytes = 4 * (floats_in + floats_out) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode(space, rows):
    return space.decode(np.atleast_2d(np.asarray(rows)), num_samples=100,
                        device="cuda")


def check_long(space, y_k, y_p, what):
    """Median |diff| of two long SSP traces within LONG_MEDIAN_TOL; prints
    the max-abs and the difference of the last decoded positions."""
    y_k, y_p = torch.as_tensor(y_k).cpu(), torch.as_tensor(y_p).cpu()
    if y_k.shape != y_p.shape:
        raise AssertionError(f"{what}: shapes {tuple(y_k.shape)} and "
                             f"{tuple(y_p.shape)} differ")
    diff = (y_k - y_p).abs()
    med = float(diff.median())
    pos_k = decode(space, y_k[-1:].numpy())
    pos_p = decode(space, y_p[-1:].numpy())
    log(f"{what}: max-abs {float(diff.max()):.3e}, median {med:.3e} "
        f"(tol {LONG_MEDIAN_TOL}), decoded position difference "
        f"{float(np.linalg.norm(pos_k - pos_p)):.4f}")
    if not med <= LONG_MEDIAN_TOL:
        raise AssertionError(f"{what}: median |diff| {med} > "
                             f"{LONG_MEDIAN_TOL}")


class SpikeCounter:
    """A neuron type that steps ``lif`` and counts the spikes it emits."""

    def __init__(self, lif, device):
        self.lif = lif
        self.spikes = torch.zeros((), dtype=torch.int64, device=device)

    def step(self, state, J, dt):
        new, act = self.lif.step(state, J, dt)
        self.spikes += torch.count_nonzero(act)
        return new, act


def count_spikes(vco, params, state, vel, corr, trace):
    """The spikes of the plain version's run of one chunk: its loop again,
    through a SpikeCounter; its SSP trace must equal ``trace``, the plain
    version's own."""
    xc0, xc1 = corr @ params.tf0T, corr @ params.tf1T
    xv = vel @ params.velT_T
    counter = SpikeCounter(vco._lif(params), vel.device)
    rows = []
    for t in range(vel.shape[0]):
        state = vco._vco_step(params, counter, state, xc0[t:t + 1],
                              xc1[t:t + 1], xv[t:t + 1])
        rows.append(state.fout)
    if not torch.equal(torch.cat(rows) @ vco.output_projection(params),
                       trace):
        raise AssertionError("the counted run differs from the plain version")
    return int(counter.spikes)


def check_kernel(fpi, space, vco):
    """Kernel vs plain version on the card, same params and inputs, for
    every cluster size; returns the worst 40-step max-abs, the plain
    version's time over the main path's first chunk and that chunk's
    spikes, and that chunk's trace from the kernel (per C) and from the
    plain version."""
    params, d = fpi.params, fpi.d
    rng = np.random.default_rng(1)
    T = SHORT + LONG
    vel = torch.tensor(0.02 * rng.normal(size=(T, 2)), dtype=torch.float32,
                       device=fpi.device)
    corr = torch.zeros((T, d), dtype=torch.float32, device=fpi.device)
    corr[:20] = torch.tensor(space.encode(np.array([[0.1, -0.2]])).ravel(),
                             dtype=torch.float32)
    state0 = fpi.initial_state()
    s_p, y_p = vco.vco_scan_reference(params, state0, vel[:SHORT],
                                      corr[:SHORT])
    _, y_p_long = vco.vco_scan_reference(params, s_p, vel[SHORT:],
                                         corr[SHORT:])
    # the main path's first chunk (CHUNK steps of its own traffic, from the
    # zero state)
    vel_c = torch.tensor(traffic()[:CHUNK], device=fpi.device)
    corr_c = torch.zeros((CHUNK, d), dtype=torch.float32, device=fpi.device)
    plain_ms, (_, y_p_chunk) = cuda_ms(
        lambda: vco.vco_scan_reference(params, state0, vel_c, corr_c))
    log(f"plain version, one {CHUNK}-step chunk: {plain_ms:.1f} ms "
        f"({CHUNK / plain_ms * 1e3:.0f} steps/s)")
    spikes = count_spikes(vco, params, state0, vel_c, corr_c, y_p_chunk)
    log(f"plain version, one {CHUNK}-step chunk: {spikes} spikes = "
        f"{spikes / (CHUNK * fpi.k * fpi.n):.5f} per neuron and step")

    worst, y_chunk = 0.0, {}
    for C in vco.CLUSTER_SIZES:
        s_k, y_k = vco._vco_scan_cuda(params, state0, vel[:SHORT],
                                      corr[:SHORT], cluster=C)
        err = float((y_k - y_p).abs().max())
        log(f"C={C}: kernel vs plain, {SHORT} steps: max-abs {err:.3e} "
            f"(tol {SHORT_TOL})")
        if not err <= SHORT_TOL:
            raise AssertionError(f"kernel (C={C}) disagrees with its plain "
                                 f"version: {err} > {SHORT_TOL}")
        worst = max(worst, err)
        # one long chunk, each version continuing from its own state
        _, y_k = vco._vco_scan_cuda(params, s_k, vel[SHORT:], corr[SHORT:],
                                    cluster=C)
        check_long(space, y_k, y_p_long,
                   f"C={C}: kernel vs plain, {LONG} steps")
        _, y_chunk[C] = vco._vco_scan_cuda(params, state0, vel_c, corr_c,
                                           cluster=C)
        check_long(space, y_chunk[C], y_p_chunk,
                   f"C={C}: kernel vs plain, {CHUNK} steps")
    return worst, plain_ms, spikes, y_chunk, y_p_chunk


def check_other_widths(vco, space_cls, fpi_cls):
    """The kernel's other neurons-per-thread variants (n = 48, 300 and
    2,000 at ssp_dim 31) against the plain version, 40 steps, every C."""
    space = make_space(space_cls, ssp_dim=31)
    rng = np.random.default_rng(2)
    vel = torch.tensor(0.05 * rng.normal(size=(SHORT, 2)),
                       dtype=torch.float32, device="cuda")
    corr = torch.zeros((SHORT, space.ssp_dim), dtype=torch.float32,
                       device="cuda")
    corr[:10] = torch.tensor(space.encode(np.array([[0.3, 0.1]])).ravel(),
                             dtype=torch.float32)
    for n in (48, 300, 2000):
        fpi = fpi_cls(space, n, seed=SEED, device="cuda")
        state0 = fpi.initial_state()
        _, y_p = vco.vco_scan_reference(fpi.params, state0, vel, corr)
        for C in vco.CLUSTER_SIZES:
            _, y_k = vco._vco_scan_cuda(fpi.params, state0, vel, corr,
                                        cluster=C)
            err = float((y_k - y_p).abs().max())
            log(f"C={C}: kernel vs plain, n={n}, k={fpi.k}, {SHORT} steps: "
                f"max-abs {err:.3e} (tol {SHORT_TOL})")
            if not err <= SHORT_TOL:
                raise AssertionError(f"kernel disagrees at n={n}, C={C}: "
                                     f"{err}")


def first_oscillators(vco, params, k):
    """The bank of the first k oscillators of ``params``."""
    cut = {f: getattr(params, f)[:k].contiguous()
           if f in ("ts0T", "ts1T") else getattr(params, f)[:, :k].contiguous()
           for f in vco.ARRAY_FIELDS}
    return params._replace(**cut)


def sweep(vco, params, vel, corr):
    """The kernel at every C against the plain version over SHORT steps,
    then ms per CHUNK-step chunk for each C of SWEEP, in that order."""
    n, k = params.bias.shape
    state0 = vco.initial_vco_state(n, k, device="cuda")
    _, y_p = vco.vco_scan_reference(params, state0, vel[:SHORT],
                                    corr[:SHORT])
    for C in vco.CLUSTER_SIZES:
        _, y_k = vco._vco_scan_cuda(params, state0, vel[:SHORT],
                                    corr[:SHORT], cluster=C)
        err = float((y_k - y_p).abs().max())
        if not err <= SHORT_TOL:
            raise AssertionError(f"kernel disagrees at n={n}, k={k}, C={C}: "
                                 f"{err}")
    times = {}
    for C in SWEEP:
        def launch():
            return vco._vco_scan_cuda(params, state0, vel, corr, cluster=C)
        launch()  # warm-up
        ms, _ = cuda_ms(launch, SWEEP_REPEATS)
        times.setdefault(C, []).append(ms)
    return times


def cluster_sweep(vco, fpi, space_cls, fpi_cls, num_sms):
    """Phase 4: the C sweep at every width of SWEEP_WIDTHS, timed in that
    order, each on the main path's first chunk of traffic (no
    corrections).  Returns {name: {C: [ms, ...]}}."""
    builds = {(2, SSP_DIM, N_NEURONS): fpi}
    results = {}
    with ClockSampler() as clocks:
        for name, dim, ssp_dim, n, k in SWEEP_WIDTHS:
            if (dim, ssp_dim, n) not in builds:
                builds[dim, ssp_dim, n] = fpi_cls(
                    make_space(space_cls, ssp_dim, dim), n, seed=SEED,
                    device="cuda")
            build = builds[dim, ssp_dim, n]
            params = (build.params if k is None
                      else first_oscillators(vco, build.params, k))
            vel = torch.tensor(traffic(dim)[:CHUNK], device="cuda")
            corr = torch.zeros((CHUNK, build.d), dtype=torch.float32,
                               device="cuda")
            results[name] = times = sweep(vco, params, vel, corr)
            k = params.bias.shape[1]
            fastest = min(times, key=lambda C: np.mean(times[C]))
            for C, ms in times.items():
                log(f"sweep, {name} (n={n}, k={k}), C={C}: ms per "
                    f"{CHUNK}-step chunk "
                    f"{', '.join(f'{t:.3f}' for t in ms)} = "
                    f"{np.mean(ms) / CHUNK * 1e6:.1f} ns per step")
            log(f"sweep, {name}: kernel vs plain <= {SHORT_TOL} over "
                f"{SHORT} steps at every C; fastest C {fastest}, the "
                f"wrapper picks {vco._cluster_size(n, k, num_sms)}")
    log(f"sweep window: {clocks.summary()}")
    return results


def main_path(fpi, vco, space, first_kernel, first_plain):
    """bench.py --model pi-fast's traffic through the user entry points.
    The warm-up chunk is the chunk check_kernel ran at the wrapper's C: it
    must match that kernel launch (max-abs <= SHORT_TOL) and agree with the
    plain version's trace of it (median |diff| <= LONG_MEDIAN_TOL).
    Returns the launches and the whole trace (CHUNK + TIMED, d)."""
    vels = traffic()
    vco.vco_scan.launches = 0
    t0 = time.perf_counter()
    warm = fpi.run(vels[:CHUNK])
    log(f"warm-up chunk: {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    before = nvidia_smi(ClockSampler.QUERY)
    t0 = time.perf_counter()
    outs = fpi.run(vels[CHUNK:], transfer=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = nvidia_smi(ClockSampler.QUERY)
    launches = vco.vco_scan.launches
    log(f"main path: {TIMED} steps in {seconds:.4f} s = "
        f"{TIMED / seconds:.0f} steps/s; vco_scan launches {launches}")
    log(f"main-path window ({ClockSampler.QUERY}): just before "
        f"{before}; just after {after}")
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    same = float(np.abs(warm - first_kernel.cpu().numpy()).max())
    log(f"main path's first chunk vs the same kernel launch: max-abs "
        f"{same:.3e} (tol {SHORT_TOL})")
    if not same <= SHORT_TOL:
        raise AssertionError(f"the main path's first chunk differs from the "
                             f"kernel launch on its inputs: {same}")
    check_long(space, warm, first_plain,
               f"main path's first chunk vs plain, {CHUNK} steps")
    out = torch.cat(outs).cpu().numpy()
    if out.shape != (TIMED, fpi.d) or not np.all(np.isfinite(out)):
        raise AssertionError(f"main-path output is not finite (T, d): "
                             f"{out.shape}")
    return launches, np.concatenate([warm, out])


def whole_run(vco, fpi, space, chosen, trace):
    """The main path's CHUNK + TIMED steps again, chunk by chunk through the
    kernel at the other cluster size: median |diff| and decoded-position
    difference at every chunk end."""
    other = 1 if chosen != 1 else 4
    vel = torch.tensor(traffic(), device="cuda")
    corr = torch.zeros((CHUNK, fpi.d), dtype=torch.float32, device="cuda")
    state = fpi.initial_state()
    ends, worst = [], 0.0
    for lo in range(0, CHUNK + TIMED, CHUNK):
        state, y = vco._vco_scan_cuda(fpi.params, state, vel[lo:lo + CHUNK],
                                      corr, cluster=other)
        y = y.cpu().numpy()
        ref = trace[lo:lo + CHUNK]
        med = float(np.median(np.abs(y - ref)))
        dist = float(np.linalg.norm(decode(space, y[-1]) -
                                    decode(space, ref[-1])))
        ends.append(dist)
        worst = max(worst, dist)
        log(f"whole run, C={chosen} vs C={other}, steps {lo}..{lo + CHUNK}: "
            f"median |diff| {med:.3e}, decoded position difference at the "
            f"chunk end {dist:.4f} (tol {DRIFT_TOL})")
    if not worst <= DRIFT_TOL:
        raise AssertionError(f"whole run: C={chosen} and C={other} decode "
                             f"{worst} apart > {DRIFT_TOL}")
    return other, ends


def accuracy(space_cls, fpi_cls):
    """tests/test_pallas.py::test_integration_accuracy at full width."""
    space = make_space(space_cls)
    d = space.ssp_dim
    v = np.array([0.2, -0.1])
    scale = 1 / np.max(np.abs(space.phase_matrix @ v.reshape(2, 1)))
    T = 800
    vels = np.tile(v * scale, (T, 1)).astype(np.float32)
    corr = np.zeros((T, d), np.float32)
    corr[:50] = space.encode(np.zeros((1, 2))).ravel()
    fpi = fpi_cls(space, N_NEURONS, seed=3, scaling_factor=scale,
                  chunk_steps=200, device="cuda")
    out = fpi.run(vels, corr)
    dec = space.decode(out[-1][None, :], num_samples=50, device="cuda")
    err = float(np.linalg.norm(dec - v * T * 0.001))
    log(f"constant-velocity decode error after {T} steps: {err:.4f} "
        f"(tol {ACCURACY_TOL})")
    if not err < ACCURACY_TOL:
        raise AssertionError(f"integration error {err} >= {ACCURACY_TOL}")


def pi_simulator(space, vels, scaling_factor=1.0, corrections=None,
                 seed=SEED):
    """``bench.py --model pi``'s network on the port's Simulator: the
    velocity table into PathIntegration (LIF), the output probed through a
    50 ms lowpass; ``corrections`` (T, d) feed the SSP input if given."""
    from sspslam_tpu_torch.models import PathIntegration
    from sspslam_tpu_torch.nef import (Connection, Network, Node, Probe,
                                       Simulator, TimeTable)
    with Network(seed=seed) as net:
        vel = Node(TimeTable(vels))
        pi = PathIntegration(space, N_NEURONS, 0.05,
                             scaling_factor=scaling_factor)
        Connection(vel, pi.velocity_input, synapse=None)
        if corrections is not None:
            Connection(Node(TimeTable(corrections)), pi.input, synapse=None)
        probe = Probe(pi.output, synapse=0.05)
    return Simulator(net, seed=seed, device="cuda"), probe


def timed_run(sim, probe, steps=TIMED):
    """One CHUNK-step warm-up segment (graph capture included), then
    ``steps`` timed steps in CHUNK-step segments; returns (steps/s, the
    whole trace, the card's clocks and power just before and just after
    the timed window)."""
    sim.reset()
    sim.preload_inputs(CHUNK + steps)
    sim.run_steps(CHUNK, segment_steps=CHUNK)
    sim.sync()
    before = nvidia_smi(ClockSampler.QUERY)
    t0 = time.perf_counter()
    sim.run_steps(steps, segment_steps=CHUNK)
    sim.sync()
    rate = steps / (time.perf_counter() - t0)
    return rate, sim.data[probe], [before, nvidia_smi(ClockSampler.QUERY)]


def profile_steps(sim, eager):
    """CUDA kernels and device busy time per step over PROFILE_STEPS steps
    (one torch.profiler pass after a warm-up): kernels, device events and
    busy us per step, the busy share of the profiled window, and the six
    kernels that took the most device time (name, us and calls per
    step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim.reset()
    sim._eager = eager
    sim.preload_inputs(2 * PROFILE_STEPS)
    sim.run_steps(PROFILE_STEPS, segment_steps=PROFILE_STEPS)
    sim.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_steps(PROFILE_STEPS, segment_steps=PROFILE_STEPS)
        sim.sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    sim._eager = False
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    by_name = {}
    for e in kernels:
        us, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    top = [(name[:80], us / PROFILE_STEPS, calls / PROFILE_STEPS)
           for name, (us, calls) in top]
    return (len(kernels) / PROFILE_STEPS, len(dev) / PROFILE_STEPS,
            busy_us / PROFILE_STEPS, busy_us / wall_us, top)


def simulator_path(space, vco, fast_trace):
    """Phase 8: the generic engine at full width on bench.py --model pi's
    traffic.  Returns the numbers of the Simulator's JSON line."""
    vels = traffic()
    t0 = time.perf_counter()
    sim, probe = pi_simulator(space, vels)
    n = sum(be.k * be.n if be.batched else be.n for be in sim.model.ensembles)
    log(f"Simulator build (d={space.ssp_dim}, {n} neurons): "
        f"{time.perf_counter() - t0:.1f} s")

    replay_err, _ = replay_vs_eager(sim, probe, "Simulator")

    k_eager, ev_eager, busy_eager, share_eager, _ = profile_steps(sim, True)
    k_graph, _, busy_graph, share_graph, top = profile_steps(sim, False)
    log(f"Simulator profile over {PROFILE_STEPS} steps: eager {k_eager:.2f} "
        f"kernels per step ({ev_eager:.2f} device events), device busy "
        f"{busy_eager:.1f} us per step = {share_eager * 100:.1f} % of the "
        f"profiled wall time; graph replay {k_graph:.2f} kernels per step, "
        f"busy {busy_graph:.1f} us per step = {share_graph * 100:.1f} %")
    for name, us, calls in top:
        log(f"  graph replay, per step: {us:6.2f} us in {calls:.2f} x {name}")

    # steps/s: graphs of U steps, then eager; the main path's window
    rates, first = {}, None
    vco.vco_scan.launches = 0
    for U in GRAPH_UNITS:
        sim._graph_steps = U
        rates[U], trace, _ = timed_run(sim, probe)
        log(f"Simulator, graphs of {U} steps: {rates[U]:.0f} steps/s over "
            f"{TIMED} steps")
        if first is None:
            first = trace
        elif not np.array_equal(trace, first):
            raise AssertionError(f"the trace with graphs of {U} steps "
                                 f"differs from the first")
    launches = vco.vco_scan.launches
    if launches != 0:
        raise AssertionError(f"the Simulator path launched vco_scan "
                             f"{launches} times")
    best = max(rates, key=rates.get)
    sim._graph_steps = best
    sim._eager = True
    eager_rate, _, _ = timed_run(sim, probe)
    sim._eager = False
    log(f"Simulator, eager: {eager_rate:.0f} steps/s over {TIMED} steps; "
        f"fastest graph length {best} steps")

    # against the fast path's trace of the same velocities (phase 5)
    if first.shape != fast_trace.shape or not np.all(np.isfinite(first)):
        raise AssertionError(f"Simulator trace {first.shape} is not finite "
                             f"or not the fast path's shape "
                             f"{fast_trace.shape}")
    ends = []
    for lo in range(0, CHUNK + TIMED, CHUNK):
        a, b = first[lo:lo + CHUNK], fast_trace[lo:lo + CHUNK]
        dist = float(np.linalg.norm(decode(space, a[-1]) - decode(space, b[-1])))
        ends.append(dist)
        log(f"Simulator vs fast path, steps {lo}..{lo + CHUNK}: median "
            f"|diff| {float(np.median(np.abs(a - b))):.3e}, decoded position "
            f"difference at the chunk end {dist:.4f} (tol {DRIFT_TOL})")
    if not max(ends) <= DRIFT_TOL:
        raise AssertionError(f"Simulator and fast path decode {max(ends)} "
                             f"apart > {DRIFT_TOL}")
    return {"neurons": n, "graph_vs_eager_max_abs": replay_err,
            "steps_per_s_by_graph_steps": {str(U): r
                                           for U, r in rates.items()},
            "graph_steps_fastest": best, "steps_per_s_eager": eager_rate,
            "kernels_per_step_eager": k_eager,
            "kernels_per_step_graph": k_graph,
            "device_busy_us_per_step_eager": busy_eager,
            "device_busy_share_eager": share_eager,
            "device_busy_us_per_step_graph": busy_graph,
            "device_busy_share_graph": share_graph,
            "top_kernels_graph": top,
            "vco_scan_launches": launches,
            "vs_fast_path_decoded_diff": ends}


def _semantics_net(nef):
    """A PES network of rate neurons with a subsampled dense probe and a
    sparse weights probe: every kind of bookkeeping the Simulator does."""
    tab = np.sin(np.linspace(0, 8, 700, dtype=np.float32))[:, None]
    with nef.Network(seed=0) as net:
        inp = nef.Node(nef.TimeTable(tab))
        a = nef.Ensemble(60, 1, neuron_type=nef.LIFRate())
        out = nef.Node(size_in=1)
        nef.Connection(inp, a, synapse=None)
        c = nef.Connection(a, out, function=lambda x: x * 0,
                           learning_rule_type=nef.PES(1e-3), synapse=0.01)
        nef.Connection(inp, c.learning_rule, transform=-1, synapse=0.005)
        nef.Connection(out, c.learning_rule, synapse=0.005)
        dense = nef.Probe(out, synapse=0.01, sample_every=0.007)
        sparse = nef.Probe(c, attr="weights", sample_every=0.1)
    return net, (dense, sparse)


def simulator_semantics():
    """The Simulator's bookkeeping through CUDA graphs against the same
    network stepped eagerly on the CPU, with the same calls: runs of
    130, 170 and 333 steps in segments of 64 (graph remainders, sparse
    clips, the global thinning phase), inputs streamed and then preloaded,
    the learning rate zeroed in place between runs (no recapture), and a
    checkpoint of the card's run continued on the CPU.  Returns the
    largest difference, relative to max(|probe|, 1)."""
    import tempfile
    from sspslam_tpu_torch import nef
    worst = 0.0

    def make(device):
        net, probes = _semantics_net(nef)
        return nef.Simulator(net, seed=0, device=device), probes

    def compare(card, host, what, rows=None):
        nonlocal worst
        for pc, ph in zip(card[1], host[1]):
            y = host[0].data[ph]
            x = card[0].data[pc][-len(y):] if rows == "tail" \
                else card[0].data[pc]
            if x.shape != y.shape:
                raise AssertionError(f"{what}: shapes {x.shape}, {y.shape}")
            err = float(np.abs(x - y).max()) / max(float(np.abs(y).max()), 1)
            worst = max(worst, err)
            if not err <= 1e-4:
                raise AssertionError(f"{what}: card vs CPU {err}")

    for preload in (False, True):
        pair = [make("cuda"), make("cpu")]
        for sim, _ in pair:
            if preload:
                sim.preload_inputs(633)
            sim.run_steps(130, segment_steps=64)
            sim.run_steps(170, segment_steps=64)
            slot = next(bc.learned_slot for bc in sim.model.connections
                        if bc.pes_rule is not None)
            sim.params["hyper"]["lr"][slot].zero_()
            sim.run_steps(333, segment_steps=64)
        compare(*pair, f"semantics, preload={preload}")
        weights = pair[0][0].data[pair[0][1][1]]   # steps 100, 200, ... 600
        if not np.array_equal(weights[-1], weights[-4]):
            raise AssertionError("a zeroed learning rate still learned")
    card, host = make("cuda"), make("cpu")
    card[0].run_steps(250, segment_steps=64)
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "ck.npz")
        card[0].save_checkpoint(ck)
        host[0].load_checkpoint(ck)
    for sim, _ in (card, host):
        sim.run_steps(150, segment_steps=64)
    compare(card, host, "checkpoint continued", rows="tail")
    log(f"Simulator semantics, card (graphs) vs CPU (eager): largest "
        f"difference {worst:.3e} (tol 1e-4)")
    return worst


def simulator_accuracy(space_cls):
    """Phase 9: the constant-velocity gate of phase 7 through the
    Simulator."""
    space = make_space(space_cls)
    v = np.array([0.2, -0.1])
    scale = 1 / np.max(np.abs(space.phase_matrix @ v.reshape(2, 1)))
    T = 800
    vels = np.tile(v * scale, (T, 1)).astype(np.float32)
    corr = np.zeros((T, space.ssp_dim), np.float32)
    corr[:50] = space.encode(np.zeros((1, 2))).ravel()
    sim, probe = pi_simulator(space, vels, scaling_factor=scale,
                              corrections=corr, seed=3)
    sim.run_steps(T)
    out = sim.data[probe]
    dec = space.decode(out[-1][None, :], num_samples=50, device="cuda")
    err = float(np.linalg.norm(dec - v * T * 0.001))
    log(f"Simulator: constant-velocity decode error after {T} steps: "
        f"{err:.4f} (tol {ACCURACY_TOL})")
    if not err < ACCURACY_TOL:
        raise AssertionError(f"Simulator integration error {err} >= "
                             f"{ACCURACY_TOL}")
    return err


def run_cli(name, *args):
    """Phases 10 and 13: ``python -m sspslam_tpu_torch.experiments.<name>``
    with ``args``, as a user runs it; it must exit 0 and print finite
    errors.  Returns (final error, median error, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"sspslam_tpu_torch.experiments.{name}",
         *args],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if not line.startswith("  sim "):
            log(f"  {name}: {line.strip()}")
    if proc.returncode != 0:
        raise AssertionError(f"{name} exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    line = next(l for l in proc.stdout.splitlines()
                if l.startswith("final distance error"))
    final, median = (float(x) for x in
                     line.replace(";", "").split()[3::2])
    if not (np.isfinite(final) and np.isfinite(median)):
        raise AssertionError(f"{name} printed {line!r}")
    log(f"{name}: exit 0 in {seconds:.1f} s; final error {final}, "
        f"median {median} (printed, not gated)")
    return final, median, seconds


def slam_world():
    """bench.py --model slam's world (``build``): the 14 s figure-eight
    path, its velocities and SLAM_LANDMARKS landmarks from the seed."""
    dt = 0.001
    ts = dt * np.arange(WORLD_STEPS)
    T = WORLD_STEPS * dt
    path = 0.8 * np.stack([np.sin(2 * np.pi * ts / T),
                           np.cos(4 * np.pi * ts / T)], axis=1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = np.random.default_rng(SEED).uniform(
        -0.7, 0.7, size=(SLAM_LANDMARKS, 2))
    return path, vels, landmarks, landmarks[None, :, :] - path[:, None, :]


def slam_simulator(space, world, gate_mode="reference", anchor=False):
    """bench.py --model slam's network on the port: SLAMNetwork at full
    width (800 LIF per VCO, memory 970, 100 neurons per circular-convolution
    dimension, clean-up over 100 x 100 samples in bf16) fed by the
    single-nearest adapter, the PI output probed through a 50 ms lowpass.
    With ``anchor`` the auto-recovery gate reads the first ANCHORS
    landmarks as surveyed beacons.  Returns (simulator, probe, build s)."""
    from sspslam_tpu_torch import SPSpace
    from sspslam_tpu_torch.models import (SLAMNetwork,
                                          get_anchor_input_functions,
                                          get_slam_input_functions)
    from sspslam_tpu_torch.nef import (Connection, Network, Node, Probe,
                                       Simulator, clamp_table)
    path, vels, landmarks, vec = world
    lm_space = SPSpace(SLAM_LANDMARKS, space.ssp_dim, seed=SEED)
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions(space, lm_space, vels, vec, VIEW_RAD)
    with Network(seed=SEED) as net:
        slam = SLAMNetwork(space, lm_space, VIEW_RAD, SLAM_LANDMARKS,
                           pi_n_neurons=N_NEURONS, mem_n_neurons=970,
                           circonv_n_neurons=100, vel_scaling_factor=scale,
                           cleanup_samples_per_dim=100, seed=SEED,
                           gate_mode=gate_mode, anchor=anchor)
        for f, dst in ((vel_f, slam.velocity_input),
                       (clamp_table(space.encode(path[:1]).ravel(), 0.05),
                        slam.pathintegrator.input),
                       (sp_f, slam.landmark_id_input),
                       (vecssp_f, slam.landmark_vec_ssp),
                       (in_view_f, slam.no_landmark_in_view)):
            Connection(Node(f), dst, synapse=None)
        if anchor:
            tables = get_anchor_input_functions(
                space, vec, np.arange(ANCHORS), landmarks[:ANCHORS],
                VIEW_RAD)
            for f, dst in zip(tables, (slam.anchor_pos_input,
                                       slam.anchor_vec_ssp,
                                       slam.no_anchor_in_view)):
                Connection(Node(f), dst, synapse=None)
        probe = Probe(slam.pathintegrator.output, synapse=0.05)
    t0 = time.perf_counter()
    sim = Simulator(net, seed=SEED, device="cuda")
    return sim, probe, time.perf_counter() - t0


def replay_vs_eager(sim, probe, what):
    """Graph replay against the eager step over LONG steps from the fresh
    state; returns the max-abs difference of the probe traces and the
    eager run's steps/s."""
    traces = {}
    for eager in (False, True):
        sim.reset()
        sim._eager = eager
        sim.preload_inputs(LONG)
        t0 = time.perf_counter()
        sim.run_steps(LONG, segment_steps=LONG)
        sim.sync()
        eager_rate = LONG / (time.perf_counter() - t0)
        traces[eager] = sim.data[probe]
    sim._eager = False
    err = float(np.abs(traces[False] - traces[True]).max())
    log(f"{what}: graph replay vs eager step, {LONG} steps: max-abs "
        f"{err:.3e} (tol {REPLAY_TOL}); eager {eager_rate:.0f} steps/s")
    if not (np.all(np.isfinite(traces[False])) and err <= REPLAY_TOL):
        raise AssertionError(f"{what}: graph replay differs from the eager "
                             f"step: {err}")
    return err, eager_rate


def tracking_cosine(space, out, path):
    """bench.py's sanity metric: the mean over the last quarter of the world
    of cos(PI output, encode(path)), the output's norm only."""
    k = min(out.shape[0], path.shape[0])
    real = space.encode(path[:k])
    sims = np.sum(out[:k] * real, axis=1) / np.maximum(
        np.linalg.norm(out[:k], axis=1), 1e-9)
    return float(np.mean(sims[-k // 4:]))


def hoisted_threshold(sim, probe):
    """An in-place change of a hoisted threshold (the gate's shift_rate set
    to 0) changes the next graph replay, with no new capture: from one
    saved state, SHIFT_STEPS replayed steps at the built shift_rate, then
    with shift_rate 0, then eagerly with 0 (the replay must equal it).
    Returns (max-abs of the first two, max-abs of the last two)."""
    from sspslam_tpu_torch.nef.simulator import _flatten
    key = next(k for k, h in sim.params["hoisted"].items()
               if "shift_rate" in h)
    rate = sim.params["hoisted"][key]["shift_rate"]
    built = rate.clone()
    leaves = _flatten(sim.state)
    saved = [x.clone() for x in leaves]
    sim.preload_inputs(SHIFT_STEPS)
    traces, graphs = [], None
    for value, eager in ((None, False), (0.0, False), (0.0, True)):
        for x, s in zip(leaves, saved):
            x.copy_(s)
        sim._preload_start = sim.n_steps   # replay the same input rows
        if value is not None:
            rate.fill_(value)
        sim._eager = eager
        sim.run_steps(SHIFT_STEPS, segment_steps=SHIFT_STEPS)
        traces.append(sim.data[probe][-SHIFT_STEPS:])
        if graphs is None:
            graphs = dict(sim._graphs)
        elif not eager and {k: id(g) for k, g in sim._graphs.items()} != \
                {k: id(g) for k, g in graphs.items()}:
            raise AssertionError("changing a hoisted threshold recaptured "
                                 "the graphs")
    sim._eager = False
    rate.copy_(built)
    moved = float(np.abs(traces[0] - traces[1]).max())
    same = float(np.abs(traces[1] - traces[2]).max())
    log(f"SLAM: shift_rate {float(built):g} -> 0 in place: the next "
        f"{SHIFT_STEPS} replayed steps move by max-abs {moved:.3e}, no new "
        f"capture; replay vs eager at 0: max-abs {same:.3e} (tol "
        f"{REPLAY_TOL})")
    if not (moved > 1e-3 and same <= REPLAY_TOL):
        raise AssertionError(f"shift_rate in place: moved {moved}, replay "
                             f"vs eager {same}")
    return moved, same


def slam_path(space, vco):
    """Phases 11 and 12: SLAMNetwork at full width on bench.py --model
    slam's traffic through the Simulator.  Returns the numbers of the SLAM
    JSON line."""
    from sspslam_tpu_torch.utils.profiling import print_utilization_summary
    world = slam_world()
    path = world[0]
    vco.vco_scan.launches = 0
    sim, probe, build_s = slam_simulator(space, world)
    n = sum(be.k * be.n if be.batched else be.n for be in sim.model.ensembles)
    log(f"SLAM build (d={space.ssp_dim}, {n} neurons): {build_s:.1f} s")
    print_utilization_summary(sim.model)
    out = {"neurons": n, "build_s": build_s}

    # (a) graph replay vs eager
    out["graph_vs_eager_max_abs"], out["steps_per_s_eager"] = \
        replay_vs_eager(sim, probe, "SLAM")

    # (b) kernels per step
    k_eager, ev_eager, busy_eager, share_eager, _ = profile_steps(sim, True)
    k_graph, _, busy_graph, share_graph, top = profile_steps(sim, False)
    log(f"SLAM profile over {PROFILE_STEPS} steps: eager {k_eager:.2f} "
        f"kernels per step ({ev_eager:.2f} device events), device busy "
        f"{busy_eager:.1f} us per step = {share_eager * 100:.1f} % of the "
        f"profiled wall time; graph replay {k_graph:.2f} kernels per step, "
        f"busy {busy_graph:.1f} us per step = {share_graph * 100:.1f} %")
    for name, us, calls in top:
        log(f"  SLAM graph replay, per step: {us:6.2f} us in {calls:.2f} x "
            f"{name}")
    out.update(kernels_per_step_eager=k_eager, kernels_per_step_graph=k_graph,
               device_busy_us_per_step_eager=busy_eager,
               device_busy_us_per_step_graph=busy_graph,
               device_busy_share_graph=share_graph, top_kernels_graph=top)

    # (c) tracking over the world, in one run from the fresh state
    sim.reset()
    sim.run_steps(WORLD_STEPS)
    trace = sim.data[probe]
    cos = tracking_cosine(space, trace, path)
    log(f"SLAM tracking cosine (last quarter of the {WORLD_STEPS}-step "
        f"world): {cos:.4f} (gate >= {TRACKING_GATE})")
    if not (trace.shape == (WORLD_STEPS, space.ssp_dim)
            and np.all(np.isfinite(trace)) and cos >= TRACKING_GATE):
        raise AssertionError(f"SLAM tracking cosine {cos} < {TRACKING_GATE} "
                             f"or the trace is not finite")
    out["tracking_cosine"] = cos

    # (f) a hoisted threshold changed in place, from the tracked state
    out["shift_rate_in_place_moved"], out["shift_rate_replay_vs_eager"] = \
        hoisted_threshold(sim, probe)

    # (d) steps/s, bench.py's timing: one warm-up segment, then TIMED steps
    rate, timed, window = timed_run(sim, probe)
    log(f"SLAM: {rate:.0f} steps/s over {TIMED} steps (graphs of "
        f"{sim._graph_steps} steps); window ({ClockSampler.QUERY}): just "
        f"before {window[0]}; just after {window[1]}")
    if not np.all(np.isfinite(timed)):
        raise AssertionError("SLAM timed run is not finite")
    out["steps_per_s"] = rate
    out["timed_window_nvidia_smi"] = window
    del sim

    # 12. the auto-recovery gate with anchors: the stateful node and the
    # in-step bind / unbind inside a captured graph
    sim, probe, build_s = slam_simulator(space, world, "auto_recovery",
                                         anchor=True)
    log(f"SLAM, auto-recovery gate with {ANCHORS} anchors: build "
        f"{build_s:.1f} s")
    out["anchor_graph_vs_eager_max_abs"], out["anchor_steps_per_s_eager"] \
        = replay_vs_eager(sim, probe, "SLAM, auto-recovery + anchor")
    del sim

    # (e) this path reaches no Pallas kernel in the JAX package
    launches = vco.vco_scan.launches
    if launches != 0:
        raise AssertionError(f"the SLAM path launched vco_scan {launches} "
                             f"times")
    out["vco_scan_launches"] = launches
    return out


def time_checkout(root: str) -> None:
    """``--time ROOT``: ms per CHUNK-step chunk of the ``vco_scan`` of the
    checkout at ``root``, at the cluster size it picks, on the main path's
    first chunk (zero state, no corrections), by CUDA events: one warm-up
    launch, then TIME_REPEATS.  Prints one JSON line."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    from sspslam_tpu_torch import FastPathIntegrator, HexagonalSSPSpace
    from sspslam_tpu_torch.ops import vco_scan as vco
    torch.backends.cuda.matmul.allow_tf32 = False
    fpi = FastPathIntegrator(make_space(HexagonalSSPSpace), N_NEURONS,
                             seed=SEED, chunk_steps=CHUNK, device="cuda")
    vel = torch.tensor(traffic()[:CHUNK], device="cuda")
    corr = torch.zeros((CHUNK, fpi.d), dtype=torch.float32, device="cuda")
    state0 = fpi.initial_state()

    def launch():
        return vco.vco_scan(fpi.params, state0, vel, corr)
    launch()  # build, load, warm up
    ms, _ = cuda_ms(launch, TIME_REPEATS)
    print(json.dumps({"root": root, "nvidia_smi": nvidia_smi(),
                      "neurons": fpi.n, "k": fpi.k, "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Smoke test of the PyTorch / CUDA port on one GPU.")
    ap.add_argument("--time", metavar="ROOT",
                    help="only time the VCO-bank kernel of the checkout at "
                         "ROOT (see the module docstring)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.time is not None:
        time_checkout(args.time)
        return 0
    from sspslam_tpu_torch import FastPathIntegrator, HexagonalSSPSpace
    from sspslam_tpu_torch.ops import vco_scan as vco

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), {name}, "
        f"{num_sms} SMs; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    _, nvcc_log = vco.build_vco_kernel()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain version, on the main path's own build
    space = make_space(HexagonalSSPSpace)
    t0 = time.perf_counter()
    fpi = FastPathIntegrator(space, N_NEURONS, seed=SEED, chunk_steps=CHUNK,
                             device="cuda")
    log(f"FastPathIntegrator build (d={fpi.d}, k={fpi.k}, n={fpi.n}): "
        f"{time.perf_counter() - t0:.1f} s")
    chosen = vco._cluster_size(fpi.n, fpi.k, num_sms)
    log(f"cluster size the wrapper picks for n={fpi.n}, k={fpi.k}: {chosen}")
    err, plain_ms, spikes, y_chunk, first_plain = check_kernel(fpi, space,
                                                               vco)
    check_other_widths(vco, HexagonalSSPSpace, FastPathIntegrator)

    # 4. cluster sweep
    swept = cluster_sweep(vco, fpi, HexagonalSSPSpace, FastPathIntegrator,
                          num_sms)
    full = swept["full width"]

    # 5. main path
    fpi.state = fpi.initial_state()
    launches, trace = main_path(fpi, vco, space, y_chunk[chosen],
                                first_plain)

    # 6. whole run against the other cluster size
    other, ends = whole_run(vco, fpi, space, chosen, trace)

    # 7. accuracy
    accuracy(HexagonalSSPSpace, FastPathIntegrator)

    # 8-10. the generic engine
    simulator = simulator_path(space, vco, trace)
    simulator["semantics_vs_cpu"] = simulator_semantics()
    simulator["accuracy_error"] = simulator_accuracy(HexagonalSSPSpace)
    final, median, seconds = run_cli("run_pathint")
    simulator["run_pathint"] = {"final_error": final, "median_error": median,
                                "seconds": seconds}

    # 11-13. SLAM
    slam = slam_path(space, vco)
    final, median, seconds = run_cli("run_slam", "--T", "20")
    slam["run_slam"] = {"final_error": final, "median_error": median,
                        "seconds": seconds}

    ms = float(np.mean(full[chosen]))
    b_ms, b_by = bound_ms(fpi.n, fpi.k, fpi.d, fpi.N, CHUNK, spikes)
    log(f"bound per {CHUNK}-step chunk ({spikes} spikes): {b_ms:.4f} ms "
        f"({b_by}); kernel {ms:.3f} ms = {b_ms / ms * 100:.2f} % of its "
        f"bound")
    print(json.dumps({"simulator": simulator}), flush=True)
    print(json.dumps({"slam": slam}), flush=True)
    log(nvidia_smi())
    print(json.dumps({"kernels": [{
        "name": "vco_scan", "route": "cuda",
        "source": "sspslam_tpu_torch/csrc/vco_scan.cu",
        "replaces": "sspslam_tpu/ops/pallas_kernels.py:247",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "cluster": chosen, "spikes": spikes,
        "ms_by_cluster": {str(C): t for C, t in full.items()},
        "floor_ms_by_cluster": {
            str(C): t for C, t in swept["floor"].items()},
        "sweep_ms_by_cluster": {
            width: {str(C): t for C, t in times.items()}
            for width, times in swept.items()},
        "whole_run_vs_cluster": other,
        "whole_run_decoded_diff": ends,
        "launched_by": ["FastPathIntegrator.run (phase 5, bench.py --model "
                        "pi-fast traffic)"],
        "launches_on_simulator_paths": {
            "pi (phase 8)": simulator["vco_scan_launches"],
            "slam (phases 11-12)": slam["vco_scan_launches"]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
