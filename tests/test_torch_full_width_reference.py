"""The JAX package's full-width reference of the port's main path,
``tests/reference/full_width_jax.npz`` (made on the CPU by
``tests/make_jax_reference.py``; ``chip_smoke.py``'s phase 34 holds the
card's runs to it).

- The file: its keys and shapes, every array finite; every seed's stored
  tracking cosine is the last-quarter mean of its cosine trace; the
  decoded positions are the port's ``SSPSpace.decode`` of the stored rows
  on the CPU (the decode phase 34 runs on the card), within 1e-4.
- The JAX side: a fresh build of ``bench.py``'s seed-0 world at full width
  reproduces the first 300 probe rows within 1e-6 over 300 steps, and the
  JAX ``FastPathIntegrator`` in Pallas interpret mode the fast path's
  first 40 rows.
- The port's CPU build at full width: ``bench.build`` (seed 0) and
  ``FastPathIntegrator`` reproduce the parameter checksums (1e-6 relative
  for host solves and seeded draws, 1e-4 for float32 device solves:
  tests/test_torch_builder.py's rule); the SLAM build, stepped 300 steps,
  the first 300 probe rows within phase 34's bounds (the spike-flip
  bounds' median, q80 and peak), and the fast path's plain version the
  first 40 rows within the kernel bound (2e-4).
- ``slow``: the generator, run again, reproduces the committed file within
  1e-6.

The JAX runs pin OpenBLAS to the generator's BLAS_THREADS, as the
generator ran: under one thread the same JAX build parts from its run at
step 17 and by up to 9.2e-4 over 300 steps.  The port's two full-width
builds run their float32 solves on four threads (one thread takes 14 s and
10 s).
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from sspslam_tpu_torch import bench  # noqa: E402
from sspslam_tpu_torch.models import FastPathIntegrator  # noqa: E402

REFERENCE = REPO / "tests" / "reference" / "full_width_jax.npz"
SEEDS = chip_smoke.REFERENCE_SEEDS
D = 97
DECODE_TOL = 1e-4
REPRODUCE_TOL = 1e-6
HOIST = ("SSPSLAM_HOIST_CLEANUP", "SSPSLAM_HOIST_GATE", "SSPSLAM_CLEANUP_F32")
BUILD_THREADS = 4


@pytest.fixture(autouse=True)
def default_knobs(monkeypatch):
    """The default (bf16) clean-up and the default, closure-held tables in
    the JAX package, as the generator builds them."""
    for name in HOIST:
        monkeypatch.delenv(name, raising=False)


@contextlib.contextmanager
def threads(n):
    """torch and BLAS limited to ``n`` threads."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        with threadpool_limits(n):
            yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def ref():
    with np.load(REFERENCE) as f:
        return {k: f[k] for k in f.files}


def port_space():
    return bench.make_space(bench.parse_args(["--device", "cpu"]))


def test_file_keys_shapes_finite(ref):
    shapes = {"fast_rows40": (40, D), "fast_rows_every1000": (60, D),
              "fast_decoded_every10000": (6, 2),
              "slam_map_new_tracking": (), "slam_map_new_item_errors": (4,)}
    for s in SEEDS:
        p = f"slam_s{s}_"
        shapes.update({p + "cos": (14_000,), p + "tracking": (),
                       p + "rows300": (300, D), p + "rows_every1000": (14, D),
                       p + "decoded_every1000": (14, 2)})
    for which in [f"slam_s{s}_" for s in SEEDS] + ["fast_"]:
        n = len(ref[which + "leaf_paths"])
        assert n > 0
        shapes.update({which + "leaf_sums": (n, 4),
                       which + "leaf_device": (n,)})
    for key, shape in shapes.items():
        assert ref[key].shape == shape, key
        assert np.all(np.isfinite(ref[key])), key
    assert set(ref) == set(shapes) | {
        w + "leaf_paths" for w in [f"slam_s{s}_" for s in SEEDS] + ["fast_"]}
    assert REFERENCE.stat().st_size <= 2 * 2 ** 20


def test_tracking_is_last_quarter_mean(ref):
    for seed in SEEDS:
        cos = ref[f"slam_s{seed}_cos"].astype(np.float64)
        assert float(ref[f"slam_s{seed}_tracking"]) == float(
            np.mean(cos[-len(cos) // 4:])), seed
        assert np.all(np.abs(cos) <= 1 + 1e-6), seed


@pytest.mark.parametrize("which", [*SEEDS, "fast"])
def test_decoded_positions_are_the_port_decode(ref, which):
    if which == "fast":
        rows = ref["fast_rows_every1000"][9::10]
        want = ref["fast_decoded_every10000"]
    else:
        rows = ref[f"slam_s{which}_rows_every1000"]
        want = ref[f"slam_s{which}_decoded_every1000"]
    with threads(1):
        got = port_space().decode(rows, num_samples=100, device="cpu")
    np.testing.assert_allclose(got, want, atol=DECODE_TOL, rtol=0)


def test_leaf_checksums_see_a_permuted_leaf():
    """The smoke's checksum holds a leaf's layout, not only its values: the
    same values transposed or in another order fail it."""
    rng = np.random.default_rng(0)
    tree = {"enc": torch.tensor(rng.normal(size=(8, 6)), dtype=torch.float32),
            "bias": [np.arange(5.0), 0.5]}
    leaves = list(chip_smoke.flat_leaves(tree))
    paths = [p for p, _ in leaves]
    sums = np.array([chip_smoke.leaf_checksum(x) for _, x in leaves])
    host = np.zeros(len(paths), bool)
    chip_smoke.check_leaf_sums(tree, paths, sums, host, "same")
    for changed in ({**tree, "enc": tree["enc"].T.contiguous()},
                    {**tree, "enc": tree["enc"].flip(0)},
                    {**tree, "bias": [np.arange(5.0)[::-1], 0.5]}):
        with pytest.raises(AssertionError, match="checksum"):
            chip_smoke.check_leaf_sums(changed, paths, sums, host, "moved")


def test_jax_slam_reproduces_first_rows(ref):
    import make_jax_reference as gen
    jb = gen.jax_bench()
    with gen.pinned_blas():
        sim, probe, _, _ = jb.build(gen.bench_args(0))
        sim.run_steps(300, segment_steps=300)
    got = np.asarray(sim.data[probe], np.float64)
    np.testing.assert_allclose(got, ref["slam_s0_rows300"], rtol=0,
                               atol=REPRODUCE_TOL)


def test_jax_fast_path_reproduces_first_rows(ref):
    import make_jax_reference as gen
    from sspslam_tpu.models import FastPathIntegrator as JaxFastPath
    with gen.pinned_blas():
        fpi = JaxFastPath(gen.jb_space(0), 800, seed=0, chunk_steps=40,
                          interpret=True)
        got = np.asarray(fpi.run(gen.fast_velocities()[:40]), np.float64)
    np.testing.assert_allclose(got, ref["fast_rows40"], rtol=0,
                               atol=REPRODUCE_TOL)


@pytest.mark.parametrize("which", ["slam", "fast"])
def test_port_cpu_build_matches_checksums(ref, which):
    with threads(BUILD_THREADS):
        if which == "slam":
            sim, probe, *_ = bench.build(bench.parse_args(["--device",
                                                           "cpu"]))
            params, key = sim.params, "slam_s0_"
        else:
            fpi = FastPathIntegrator(port_space(), 800, seed=0,
                                     chunk_steps=40, device="cpu")
            params, key = fpi.params, "fast_"
    worst = chip_smoke.check_leaf_sums(
        params, ref[key + "leaf_paths"], ref[key + "leaf_sums"],
        ref[key + "leaf_device"], which)
    assert worst["host"] <= chip_smoke.HOST_LEAF_RTOL
    assert worst["device"] <= chip_smoke.DEVICE_LEAF_RTOL
    if which == "slam":
        with threads(BUILD_THREADS):
            sim.run_steps(chip_smoke.REFERENCE_ROWS)
        chip_smoke.check_first_rows(sim.data[probe], ref["slam_s0_rows300"],
                                    "the port's SLAM on the CPU, seed 0")
    else:
        vels = (0.02 * np.random.default_rng(0).normal(size=(40, 2))).astype(
            np.float32)
        with threads(1):
            got = fpi.run(vels)
        err = float(np.abs(got - ref["fast_rows40"]).max())
        assert err <= chip_smoke.SHORT_TOL, err


@pytest.mark.slow
def test_generator_reproduces_the_file(tmp_path, ref):
    env = {k: v for k, v in os.environ.items() if k not in HOIST}
    subprocess.run([sys.executable, str(REPO / "tests" /
                                        "make_jax_reference.py"),
                    "--out", str(tmp_path)],
                   check=True, cwd=REPO, env=env, timeout=3600)
    with np.load(tmp_path / "full_width_jax.npz") as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(ref)
    for key, want in ref.items():
        if want.dtype.kind in "fc":
            np.testing.assert_allclose(got[key], want, rtol=REPRODUCE_TOL,
                                       atol=REPRODUCE_TOL, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want, err_msg=key)
