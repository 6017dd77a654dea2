"""Make the JAX package's full-width reference of the port's main path.

    JAX_PLATFORMS=cpu python tests/make_jax_reference.py [--out DIR]

Writes ``full_width_jax.npz`` (``np.savez_compressed``) and
``full_width_jax.json`` (provenance) into ``--out`` (default
``tests/reference``).  The files are data made from the JAX package in
this repo, on the CPU, by this script; run it again to make them again
(about seven minutes on an 8-core host).  The port
and ``chip_smoke.py`` import no JAX: the smoke's phase 34 reads the npz and
holds the card's runs against it, and
``tests/test_torch_full_width_reference.py`` holds the file, the JAX package
and the port's CPU build to it.

What it holds:

- **SLAM**, for each seed s in 0-4: ``bench.py``'s ``build`` at its defaults
  (ssp_dim 97, 800 LIF per VCO, memory 970, 100 per convolution dimension,
  10 landmarks, 100 clean-up samples per dimension, the 14 s figure-eight,
  the clean-up's default bf16 similarity) stepped 14,000 steps:
  ``slam_s{s}_cos`` the per-step cosine ``bench.py`` averages over the last
  quarter (float32), ``slam_s{s}_tracking`` that mean,
  ``slam_s{s}_rows300`` the probe's first 300 rows,
  ``slam_s{s}_rows_every1000`` the rows at steps 999, 1999, ..., 13999 and
  ``slam_s{s}_decoded_every1000`` their ``space.decode`` (from-set, a
  100 x 100 grid); ``slam_s{s}_leaf_paths`` / ``_leaf_sums`` /
  ``_leaf_device`` the checksums of the built parameters (below).
- **Fast path**: ``bench.py --model pi-fast``'s world (seed 0, velocities
  ``0.02 * default_rng(0).normal((60000, 2))``) through
  ``FastPathIntegrator(space, 800, seed=0, chunk_steps=10000,
  interpret=True)`` (the Pallas kernel in interpret mode), run as
  ``run(vels[:10000])`` then ``run(vels[10000:])``: ``fast_rows40``,
  ``fast_rows_every1000`` (steps 999, ..., 59999),
  ``fast_decoded_every10000`` (the six chunk ends) and ``fast_leaf_*``
  (of the parameters without their lane padding, the port's layout).
- **slam_map_new**: ``experiments/slam_map_new.py --T 20`` at its default
  widths, the numbers it prints: ``slam_map_new_tracking`` (mean cosine
  over the last half) and ``slam_map_new_item_errors`` (the four items).

Checksums: for every leaf, by its slash path (dict keys sorted, list items
by index; a parameter NamedTuple by field), ``chip_smoke.leaf_checksum``:
[float64 sum, L2 norm, L1 norm, sum weighted by position].  The SLAM's
are of the build with the clean-up bank and the gate's thresholds hoisted
into ``params["hoisted"]`` (``SSPSLAM_HOIST_CLEANUP=1
SSPSLAM_HOIST_GATE=1``, the port's layout; its other leaves equal the
default build's bit for bit, which this script asserts).  ``_leaf_device``
marks the leaves that hold decoders solved in float32 on the device (the
builder's batched solve above ``DEVICE_SOLVE_MIN_BATCH_ELEMS``); the rest
are host solves or drawn from the seed.

BLAS: everything runs with OpenBLAS on BLAS_THREADS threads, whatever the
host's core count or its ``OPENBLAS_NUM_THREADS``: the builder's NumPy
solves round by the thread count (on one thread the same JAX build parts
from this file's SLAM trace at step 17, by up to 9.2e-4 over 300 steps;
four and eight agree bit for bit).  The JSON records the threads and each
BLAS library's version and kernel architecture.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the repo's tests' XLA configuration (tests/conftest.py)
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from threadpoolctl import threadpool_info, threadpool_limits  # noqa: E402

# the seeds, leaf paths and checksums phase 34 compares, from their one
# definition
from chip_smoke import (REFERENCE_SEEDS as SEEDS, flat_leaves,  # noqa: E402
                        leaf_checksum as checksum)

jax.config.update("jax_platforms", "cpu")

WORLD_STEPS = 14_000
SLAM_SEGMENT = 2_000
FAST_CHUNK = 10_000
FAST_STEPS = 60_000
EVERY = 1_000
DECODE_SAMPLES = 100
MAP_NEW_T = 20.0
HOIST = ("SSPSLAM_HOIST_CLEANUP", "SSPSLAM_HOIST_GATE")
FAST_DECODERS = ("drec0", "drec1", "drec2", "dout0", "dout1")
BLAS_THREADS = 4


@contextlib.contextmanager
def pinned_blas():
    """NumPy's and SciPy's OpenBLAS on BLAS_THREADS threads (SciPy is
    loaded first: threadpool_limits reaches only loaded libraries)."""
    import scipy.linalg  # noqa: F401
    with threadpool_limits(BLAS_THREADS):
        yield


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def jax_bench():
    """The repo's ``bench.py`` as a module."""
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bench_args(seed):
    """``bench.py``'s defaults for ``build``."""
    return argparse.Namespace(
        ssp_dim=97, pi_n_neurons=800, mem_n_neurons=970,
        circonv_n_neurons=100, n_landmarks=10, cleanup_samples=100,
        seed=seed, scan_unroll=8, bf16=False, world_T=14.0)


def device_solved_slam(model):
    """Leaf paths of the SLAM params that hold device-solved decoders: a
    connection's ``D`` whose decoders the builder left as a device array,
    and every decode stack that holds one."""
    from sspslam_tpu.nef import executor
    dev = {bc.index for bc in model.connections
           if bc.decoders is not None
           and not isinstance(bc.decoders, np.ndarray)}
    paths = {f"conn/{i}/D" for i in dev}
    for groups in (executor._elem_decode_groups(model),
                   executor._ea_batch_decode_groups(model)):
        for key, bcs in groups.items():
            if any(bc.index in dev for bc in bcs):
                paths.add(f"dstack/{key}")
    return paths


def slam_checksums(jb, seed, default_params):
    """Checksums of the hoisted build of ``seed``'s world; its leaves but
    the hoisted ones must equal ``default_params``' bit for bit."""
    saved = {k: os.environ.get(k) for k in HOIST}
    os.environ.update({k: "1" for k in HOIST})
    try:
        sim, *_ = jb.build(bench_args(seed))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    hoisted = dict(flat_leaves(sim.params))
    default = dict(flat_leaves(default_params))
    assert set(default) <= set(hoisted), set(default) - set(hoisted)
    for path, leaf in default.items():
        assert np.array_equal(np.asarray(leaf), np.asarray(hoisted[path])), \
            f"hoisting changed {path}"
    device = device_solved_slam(sim.model)
    paths = sorted(hoisted)
    return (np.array(paths), np.array([checksum(hoisted[p]) for p in paths]),
            np.array([p in device for p in paths]))


def slam_seed(jb, seed):
    """One seed's world at bench.py's defaults: the arrays of the npz and
    the seconds it took."""
    t0 = time.perf_counter()
    sim, probe, space, path = jb.build(bench_args(seed))
    sim.run_steps(WORLD_STEPS, segment_steps=SLAM_SEGMENT)
    out = np.asarray(sim.data[probe], np.float32)[:WORLD_STEPS]
    real = space.encode(path[:WORLD_STEPS])
    cos = (np.sum(out * real, axis=1) / np.maximum(
        np.linalg.norm(out, axis=1), 1e-9)).astype(np.float32)
    tracking = float(np.mean(cos.astype(np.float64)[-WORLD_STEPS // 4:]))
    rows = out[EVERY - 1::EVERY]
    decoded = np.asarray(space.decode(rows, num_samples=DECODE_SAMPLES))
    paths, sums, device = slam_checksums(jb, seed, sim.params)
    seconds = time.perf_counter() - t0
    log(f"SLAM seed {seed}: tracking {tracking:.4f}, {seconds:.1f} s")
    p = f"slam_s{seed}_"
    return {p + "cos": cos, p + "tracking": np.float64(tracking),
            p + "rows300": out[:300], p + "rows_every1000": rows,
            p + "decoded_every1000": decoded.astype(np.float64),
            p + "leaf_paths": paths, p + "leaf_sums": sums,
            p + "leaf_device": device}, seconds


def jb_space(seed):
    """bench.py's space (``bench_pi``'s and ``build``'s)."""
    from sspslam_tpu import HexagonalSSPSpace
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    return HexagonalSSPSpace(2, ssp_dim=97, seed=seed, length_scale=0.3,
                             domain_bounds=bounds)


def fast_velocities():
    """bench.py --model pi-fast's velocities (seed 0)."""
    rng = np.random.default_rng(0)
    return (0.02 * rng.normal(size=(FAST_STEPS, 2))).astype(np.float32)


def unpadded(params, k):
    """JAX's VCO parameters with the oscillator axis cut back from its
    lane padding (``pad_vco_params_to_lanes``: zero columns, zero rows of
    ``ts0T`` / ``ts1T``) to its ``k`` oscillators: the port's layout."""
    cut = {}
    for name, x in params._asdict().items():
        x = np.asarray(x)
        if x.ndim != 2:
            continue
        if name in ("ts0T", "ts1T"):
            x, pad = x[:k], x[k:]
        else:
            x, pad = x[:, :k], x[:, k:]
        assert not pad.any(), f"{name}'s padding is not zero"
        cut[name] = x
    return params._replace(**cut)


def fast_path(jb):
    """The fast path's whole run in Pallas interpret mode."""
    from sspslam_tpu.models import FastPathIntegrator
    t0 = time.perf_counter()
    space = jb_space(0)
    fpi = FastPathIntegrator(space, 800, seed=0, chunk_steps=FAST_CHUNK,
                             interpret=True)
    vels = fast_velocities()
    out = np.concatenate([np.asarray(fpi.run(vels[:FAST_CHUNK])),
                          np.asarray(fpi.run(vels[FAST_CHUNK:]))])
    out = out.astype(np.float32)
    assert out.shape == (FAST_STEPS, fpi.d), out.shape
    ends = out[FAST_CHUNK - 1::FAST_CHUNK]
    decoded = np.asarray(space.decode(ends, num_samples=DECODE_SAMPLES))
    leaves = list(flat_leaves(unpadded(fpi.params, (fpi.d + 1) // 2)))
    seconds = time.perf_counter() - t0
    log(f"fast path: {FAST_STEPS} steps, {seconds:.1f} s")
    return {"fast_rows40": out[:40],
            "fast_rows_every1000": out[EVERY - 1::EVERY],
            "fast_decoded_every10000": decoded.astype(np.float64),
            "fast_leaf_paths": np.array([p for p, _ in leaves]),
            "fast_leaf_sums": np.array([checksum(x) for _, x in leaves]),
            "fast_leaf_device": np.array([p in FAST_DECODERS
                                          for p, _ in leaves])}, seconds


def slam_map_new():
    """``experiments/slam_map_new.py --T 20`` at its default widths on the
    CPU: its printed tracking cosine and four item errors."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as figures:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "experiments" / "slam_map_new.py"),
             "--T", str(MAP_NEW_T), "--backend", "cpu",
             "--save-dir", figures],
            capture_output=True, text=True, cwd=ROOT, timeout=3600,
            env=dict(os.environ, OPENBLAS_NUM_THREADS=str(BLAS_THREADS),
                     PYTHONPATH=os.pathsep.join(filter(None, [
                         str(ROOT), os.environ.get("PYTHONPATH")]))))
    if proc.returncode != 0:
        raise RuntimeError(f"slam_map_new exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    tracking = float(re.search(r"tracking cosine sim \(mean, last half\): "
                               r"(\S+)", proc.stdout).group(1))
    errors = [float(x) for x in
              re.findall(r"map\[[^]]+\]: location error (\S+)", proc.stdout)]
    assert len(errors) == 4, proc.stdout
    seconds = time.perf_counter() - t0
    log(f"slam_map_new --T {MAP_NEW_T:g}: tracking {tracking}, item errors "
        f"{errors}, {seconds:.1f} s")
    return {"slam_map_new_tracking": np.float64(tracking),
            "slam_map_new_item_errors": np.array(errors)}, seconds


def git_commit():
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain", "--",
                                "sspslam_tpu", "bench.py", "experiments"],
                               cwd=ROOT, capture_output=True,
                               text=True).stdout.strip()
        return head + ("+changes" if dirty else "")
    except (OSError, subprocess.CalledProcessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "reference"))
    args = ap.parse_args(argv)
    from sspslam_tpu.ops.vsa import default_cleanup_dtype
    jb = jax_bench()
    arrays, seconds = {}, {}
    with pinned_blas():
        blas = [{k: lib.get(k) for k in ("internal_api", "version",
                                           "architecture", "num_threads")}
                for lib in threadpool_info() if lib["user_api"] == "blas"]
        for s in SEEDS:
            part, seconds[f"slam_s{s}"] = slam_seed(jb, s)
            arrays.update(part)
        part, seconds["fast_path"] = fast_path(jb)
        arrays.update(part)
    part, seconds["slam_map_new"] = slam_map_new()
    arrays.update(part)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out / "full_width_jax.npz", **arrays)
    provenance = {
        "made_by": "tests/make_jax_reference.py",
        "commit": git_commit(),
        "jax": jax.__version__, "numpy": np.__version__,
        "python": sys.version.split()[0],
        "platform": jax.devices()[0].platform,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "blas_threads": BLAS_THREADS, "blas": blas,
        "cleanup_dtype": np.dtype(default_cleanup_dtype()).name,
        "slam": {"bench_build": vars(bench_args(None)) | {"seed": SEEDS},
                 "steps": WORLD_STEPS, "segment_steps": SLAM_SEGMENT,
                 "tracking_cosine": {str(s): float(arrays[
                     f"slam_s{s}_tracking"]) for s in SEEDS}},
        "fast_path": {"n_neurons": 800, "chunk_steps": FAST_CHUNK,
                      "steps": FAST_STEPS, "interpret": True},
        "slam_map_new": {
            "T": MAP_NEW_T,
            "tracking": float(arrays["slam_map_new_tracking"]),
            "item_errors": arrays["slam_map_new_item_errors"].tolist()},
        "seconds": seconds,
        "npz_bytes": (out / "full_width_jax.npz").stat().st_size}
    (out / "full_width_jax.json").write_text(
        json.dumps(provenance, indent=1) + "\n")
    log(f"wrote {out / 'full_width_jax.npz'} "
        f"({provenance['npz_bytes']} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
