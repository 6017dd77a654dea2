"""Smoke test of the PyTorch / CUDA port on one Hopper GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and imports nothing of JAX or of the JAX package.
Phases (each raises on failure, so the script exits non-zero and prints no
result line):

1. device: the card's name and power limit; TF32 off for matmuls and
   convolutions, so float32 comparisons are float32;
2. build: compiles ``sspslam_tpu_torch/csrc/vco_scan.cu`` for sm_90a;
3. kernel check: at the path integrator's full width (ssp_dim 97 -> k = 49
   oscillators, 800 LIF neurons each) the VCO-bank kernel against its plain
   PyTorch version on the same params and inputs: 40 steps to max-abs
   <= 2e-4, then a 2,000-step chunk and the main path's first 10,000-step
   chunk to median |diff| <= 2e-3 (single spike flips grow with the step
   count, so the long chunks bound the median); then 40 steps at 48, 300
   and 2,000 neurons per oscillator, which run the kernel's other
   neurons-per-thread variants;
4. main path: ``FastPathIntegrator`` driven with ``bench.py --model
   pi-fast``'s traffic (one 10,000-step warm-up chunk, then 50,000 timed
   steps); the kernel's launch count over that run must be > 0, and the
   warm-up chunk's trace must agree with the plain version's trace of the
   same chunk (median |diff| <= 2e-3);
5. accuracy: the constant-velocity integration test at full width (decode
   error < 0.25 after 800 steps).

The last three lines of standard output are the card's name and power
limit, one JSON object describing the kernel, and the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SSP_DIM = 97
N_NEURONS = 800
CHUNK = 10_000
TIMED = 50_000
SEED = 0
SHORT, LONG = 40, 2_000
SHORT_TOL = 2e-4      # max-abs over 40 steps (tests/test_pallas.py bound)
LONG_MEDIAN_TOL = 2e-3  # median |diff| over one 2,000-step chunk
ACCURACY_TOL = 0.25   # decode error after 800 steps at constant velocity


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def make_space(space_cls):
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    return space_cls(2, ssp_dim=SSP_DIM, seed=SEED, length_scale=0.3,
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


def traffic():
    """bench.py --model pi-fast's velocities: warm-up chunk, then timed."""
    rng = np.random.default_rng(SEED)
    return (0.02 * rng.normal(size=(CHUNK + TIMED, 2))).astype(np.float32)


def check_long(space, y_k, y_p, what):
    """Median |diff| of two long SSP traces within LONG_MEDIAN_TOL; prints
    the max-abs and the difference of the last decoded positions."""
    y_k, y_p = torch.as_tensor(y_k).cpu(), torch.as_tensor(y_p).cpu()
    if y_k.shape != y_p.shape:
        raise AssertionError(f"{what}: shapes {tuple(y_k.shape)} and "
                             f"{tuple(y_p.shape)} differ")
    diff = (y_k - y_p).abs()
    med = float(diff.median())
    pos_k = space.decode(y_k[-1:].numpy(), num_samples=100)
    pos_p = space.decode(y_p[-1:].numpy(), num_samples=100)
    log(f"{what}: max-abs {float(diff.max()):.3e}, median {med:.3e} "
        f"(tol {LONG_MEDIAN_TOL}), decoded position difference "
        f"{float(np.linalg.norm(pos_k - pos_p)):.4f}")
    if not med <= LONG_MEDIAN_TOL:
        raise AssertionError(f"{what}: median |diff| {med} > "
                             f"{LONG_MEDIAN_TOL}")


def check_kernel(fpi, space, vco):
    """Kernel vs plain version on the card, same params and inputs."""
    params, d = fpi.params, fpi.d
    rng = np.random.default_rng(1)
    T = SHORT + LONG
    vel = torch.tensor(0.02 * rng.normal(size=(T, 2)), dtype=torch.float32,
                       device=fpi.device)
    corr = torch.zeros((T, d), dtype=torch.float32, device=fpi.device)
    corr[:20] = torch.tensor(space.encode(np.array([[0.1, -0.2]])).ravel(),
                             dtype=torch.float32)
    state0 = fpi.initial_state()

    s_k, y_k = vco.vco_scan(params, state0, vel[:SHORT], corr[:SHORT])
    s_p, y_p = vco.vco_scan_reference(params, state0, vel[:SHORT],
                                      corr[:SHORT])
    err = float((y_k - y_p).abs().max())
    log(f"kernel vs plain, {SHORT} steps: max-abs {err:.3e} "
        f"(tol {SHORT_TOL})")
    if not err <= SHORT_TOL:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{err} > {SHORT_TOL}")

    # one long chunk, each version continuing from its own state
    _, y_k = vco.vco_scan(params, s_k, vel[SHORT:], corr[SHORT:])
    _, y_p = vco.vco_scan_reference(params, s_p, vel[SHORT:], corr[SHORT:])
    check_long(space, y_k, y_p, f"kernel vs plain, {LONG} steps")

    # the main path's first chunk (CHUNK steps of its own traffic, from the
    # zero state): device time of kernel and plain, and their agreement
    vel = torch.tensor(traffic()[:CHUNK], device=fpi.device)
    corr = torch.zeros((CHUNK, d), dtype=torch.float32, device=fpi.device)
    vco.vco_scan(params, state0, vel, corr)   # warm-up
    ms, (_, y_k) = cuda_ms(lambda: vco.vco_scan(params, state0, vel, corr), 3)
    plain_ms, (_, y_p) = cuda_ms(
        lambda: vco.vco_scan_reference(params, state0, vel, corr))
    log(f"one {CHUNK}-step chunk: kernel {ms:.3f} ms "
        f"({CHUNK / ms * 1e3:.0f} steps/s), plain {plain_ms:.1f} ms "
        f"({CHUNK / plain_ms * 1e3:.0f} steps/s)")
    check_long(space, y_k, y_p, f"kernel vs plain, {CHUNK} steps")
    plain_long_ms, _ = cuda_ms(lambda: vco.vco_scan_reference(
        params, state0, vel[:LONG], corr[:LONG]))
    log(f"plain version over one {LONG}-step chunk: "
        f"{LONG / plain_long_ms * 1e3:.0f} steps/s")
    return err, ms, plain_ms, y_k, y_p


def check_other_widths(vco, space_cls, fpi_cls):
    """The kernel's other neurons-per-thread variants (1 at n = 48 and 300,
    4 at n = 2,000; full width runs 2) against the plain version, 40
    steps."""
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = space_cls(2, ssp_dim=31, seed=SEED, length_scale=0.3,
                      domain_bounds=bounds)
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
        _, y_k = vco.vco_scan(fpi.params, state0, vel, corr)
        _, y_p = vco.vco_scan_reference(fpi.params, state0, vel, corr)
        err = float((y_k - y_p).abs().max())
        log(f"kernel vs plain, n={n}, k={fpi.k}, {SHORT} steps: "
            f"max-abs {err:.3e} (tol {SHORT_TOL})")
        if not err <= SHORT_TOL:
            raise AssertionError(f"kernel disagrees at n={n}: {err}")


def main_path(fpi, vco, space, first_kernel, first_plain):
    """bench.py --model pi-fast's traffic through the user entry points.
    The warm-up chunk is the chunk check_kernel ran: it must match that
    kernel launch (max-abs <= SHORT_TOL) and agree with the plain version's
    trace of it (median |diff| <= LONG_MEDIAN_TOL)."""
    vels = traffic()
    vco.vco_scan.launches = 0
    t0 = time.perf_counter()
    warm = fpi.run(vels[:CHUNK])
    log(f"warm-up chunk: {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = fpi.run(vels[CHUNK:], transfer=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = vco.vco_scan.launches
    log(f"main path: {TIMED} steps in {seconds:.4f} s = "
        f"{TIMED / seconds:.0f} steps/s; vco_scan launches {launches}")
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
    return launches


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
    dec = space.decode(out[-1][None, :], num_samples=50)
    err = float(np.linalg.norm(dec - v * T * 0.001))
    log(f"constant-velocity decode error after {T} steps: {err:.4f} "
        f"(tol {ACCURACY_TOL})")
    if not err < ACCURACY_TOL:
        raise AssertionError(f"integration error {err} >= {ACCURACY_TOL}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sspslam_tpu_torch import FastPathIntegrator, HexagonalSSPSpace
    from sspslam_tpu_torch.ops import vco_scan as vco

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), {name}; "
        f"nvidia-smi: {smi}")
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
    err, ms, plain_ms, first_kernel, first_plain = check_kernel(
        fpi, space, vco)
    check_other_widths(vco, HexagonalSSPSpace, FastPathIntegrator)

    # 4. main path
    fpi.state = fpi.initial_state()
    launches = main_path(fpi, vco, space, first_kernel, first_plain)

    # 5. accuracy
    accuracy(HexagonalSSPSpace, FastPathIntegrator)

    log(nvidia_smi())
    print(json.dumps({"kernels": [{
        "name": "vco_scan", "route": "cuda",
        "source": "sspslam_tpu_torch/csrc/vco_scan.cu",
        "replaces": "sspslam_tpu/ops/pallas_kernels.py:247",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
