"""The sharded VCO scan (``parallel/shard_step``) on the CPU: the port's
plain sharded scan against the JAX package's ``shard_map`` version on the
8-device CPU mesh, and against the port's own unsharded plain scan.

Bounds: JAX vs port 2e-4 max-abs over 30 steps (tests/test_parallel.py's
bound for the JAX sharded scan against its unsharded reference step); the
port sharded vs unsharded 1e-5 max-abs (only the order of the shards' sum
differs); ``pad_vco_params`` bit for bit; two consecutive chunks against
one chunk of twice the length 1e-6 max-abs (the chunk's input projections
are one matmul each, whose blocking may follow the row count).
"""

import numpy as np
import pytest
import torch

from sspslam_tpu import HexagonalSSPSpace as JaxHexagonalSSPSpace
from sspslam_tpu.models.fast_pathint import (
    FastPathIntegrator as JaxFastPathIntegrator)
from sspslam_tpu.parallel import make_mesh
from sspslam_tpu.parallel import shard_step as jax_shard_step

from sspslam_tpu_torch.ops import vco_scan as vs
from sspslam_tpu_torch.parallel import make_sharded_vco_scan, pad_vco_params

JAX_TOL = 2e-4
SHARD_TOL = 1e-5
CHUNK_TOL = 1e-6
T = 30


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """tests/test_parallel.py's sharded-scan set-up: its ``space``, 40
    neurons per VCO, 30 steps, one correction at step 0."""
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = JaxHexagonalSSPSpace(2, ssp_dim=31, seed=0, length_scale=0.3,
                                 domain_bounds=bounds)
    fpi = JaxFastPathIntegrator(space, 40, seed=0, interpret=True,
                                mxu_decode=False)
    rng = np.random.default_rng(0)
    vels = (0.03 * rng.normal(size=(T, 2))).astype(np.float32)
    corr = np.zeros((T, space.ssp_dim), np.float32)
    corr[0] = space.encode(np.array([[0.1, -0.1]])).flatten()
    arrays = {f: np.asarray(getattr(fpi.params, f)) for f in vs.ARRAY_FIELDS}
    consts = {f: getattr(fpi.params, f) for f in vs.CONST_FIELDS}
    params = vs.vco_params_from_numpy(arrays, consts, device="cpu")
    return fpi, params, vels, corr


def _sharded(params, n_shards, vels, corr, steps=T):
    run = make_sharded_vco_scan(params, n_shards, steps, device="cpu")
    return run(run.initial_state(), vels, corr)


def test_sharded_scan_matches_jax_shard_map(setup):
    fpi, params, vels, corr = setup
    run = jax_shard_step.make_sharded_vco_scan(fpi.params, make_mesh(8), T)
    _, want = run(run.initial_state(), vels, corr)
    _, got = _sharded(params, 8, vels, corr)
    want = np.asarray(want)
    assert got.shape == want.shape == (T, corr.shape[1])
    assert np.all(np.isfinite(want))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= JAX_TOL, err


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_scan_matches_unsharded(setup, n_shards):
    """S = 1, an uneven split (13 oscillators in 3 shards of 5: two
    silent padding oscillators) and 8 shards of 2 (three padding) against
    the unsharded plain scan; the state carries per shard, the DC
    oscillator's pin in shard 0."""
    _, params, vels, corr = setup
    n, k = params.bias.shape
    _, want = vs.vco_scan_reference(
        params, vs.initial_vco_state(n, k, device="cpu"),
        torch.tensor(vels), torch.tensor(corr))
    state, got = _sharded(params, n_shards, vels, corr)
    assert len(state) == n_shards
    assert all(s.voltage.shape == (n, -(-k // n_shards)) for s in state)
    assert float(state[0].f0.abs().max()) > 0
    err = float((got - want).abs().max())
    assert err <= SHARD_TOL, err


@pytest.mark.parametrize("n_shards", [3, 5, 7, 8])
def test_pad_vco_params_equals_jax(setup, n_shards):
    fpi, params, _, _ = setup
    want = jax_shard_step.pad_vco_params(fpi.params, n_shards)
    got = pad_vco_params(params, n_shards)
    for name in vs.ARRAY_FIELDS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), name
    for name in vs.CONST_FIELDS:
        assert getattr(got, name) == getattr(want, name)


def test_two_chunks_equal_one_of_twice_the_length(setup):
    _, params, vels, corr = setup
    rng = np.random.default_rng(1)
    vels2 = np.concatenate([vels, (0.03 * rng.normal(size=(T, 2)))
                            .astype(np.float32)])
    corr2 = np.concatenate([corr, np.zeros_like(corr)])
    half = make_sharded_vco_scan(params, 3, T, device="cpu")
    state = half.initial_state()
    state, first = half(state, vels2[:T], corr2[:T])
    state, second = half(state, vels2[T:], corr2[T:])
    end, whole = _sharded(params, 3, vels2, corr2, steps=2 * T)
    err = float((torch.cat([first, second]) - whole).abs().max())
    assert err <= CHUNK_TOL, err
    for a, b in zip(state, end):
        for x, y in zip(a, b):
            assert float((x - y).abs().max()) <= CHUNK_TOL


def test_refuses_chunks_of_another_length(setup):
    _, params, vels, corr = setup
    run = make_sharded_vco_scan(params, 2, T + 1, device="cpu")
    with pytest.raises(ValueError, match="chunks of"):
        run(run.initial_state(), vels, corr)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_defaults_to_the_card(setup):
    """``device`` defaults to ``cuda``; without a card the build raises
    instead of stepping on the CPU."""
    _, params, _, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sharded_vco_scan(params, 2, T)
