"""The VCO-bank scan: the port's plain PyTorch version (what the CUDA kernel
is held against on the card) against the JAX package's reference step and
both of its Pallas kernels, run in interpret mode as tests/test_pallas.py
runs them.

Params come either carried across from the JAX package
(``vco_params_from_numpy``) or built by the port's own FastPathIntegrator.
Tolerance: 2e-4 max-abs over 40 steps, the bound of tests/test_pallas.py
(the port's LIF uses expm1/log1p where the Pallas kernels use 1-exp and
log(1-x), and sums run in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sspslam_tpu import HexagonalSSPSpace as JaxHexagonalSSPSpace
from sspslam_tpu.models.fast_pathint import (
    FastPathIntegrator as JaxFastPathIntegrator)
from sspslam_tpu.ops import pallas_kernels as pk

from sspslam_tpu_torch import FastPathIntegrator, HexagonalSSPSpace
from sspslam_tpu_torch.ops import vco_scan as vs

TOL = 2e-4
T = 40
N_NEURONS = 48


@pytest.fixture(scope="module")
def setup():
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    kw = dict(ssp_dim=31, seed=0, length_scale=0.3, domain_bounds=bounds)
    js = JaxHexagonalSSPSpace(2, **kw)
    jfpi = JaxFastPathIntegrator(js, N_NEURONS, seed=0, chunk_steps=T,
                                 interpret=True, mxu_decode=False)
    tfpi = FastPathIntegrator(HexagonalSSPSpace(2, **kw), N_NEURONS, seed=0,
                              chunk_steps=T, device="cpu")
    rng = np.random.default_rng(0)
    vels = (0.02 * rng.normal(size=(T, 2))).astype(np.float32)
    corr = np.zeros((T, js.ssp_dim), np.float32)
    corr[:10] = js.encode(np.array([[0.1, 0.1]])).ravel()
    return js, jfpi, tfpi, vels, corr


def _jax_arrays(params):
    arrays = {f: np.asarray(getattr(params, f)) for f in vs.ARRAY_FIELDS}
    consts = {f: getattr(params, f) for f in vs.CONST_FIELDS}
    return arrays, consts


def _port_params(setup, source):
    _, jfpi, tfpi, _, _ = setup
    if source == "ported":
        return tfpi.params
    return vs.vco_params_from_numpy(*_jax_arrays(jfpi.params), device="cpu")


def _port_run(params, vels, corr):
    k = params.bias.shape[1]
    state = vs.initial_vco_state(params.bias.shape[0], k, device="cpu")
    return vs.vco_scan_reference(params, state, torch.tensor(vels),
                                 torch.tensor(corr))


def _max_abs(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.max(np.abs(a - np.asarray(b))))


@pytest.mark.parametrize("source", ["carried", "ported"])
def test_plain_matches_jax_reference_step(setup, source):
    _, jfpi, _, vels, corr = setup
    state = jfpi.initial_state()
    ref = []
    for t in range(T):
        state, y = pk.vco_reference_step(jfpi.params, state, vels[t], corr[t])
        ref.append(np.asarray(y))
    _, out = _port_run(_port_params(setup, source), vels, corr)
    assert out.shape == (T, jfpi.d)
    assert _max_abs(out, np.stack(ref)) <= TOL


@pytest.mark.parametrize("source", ["carried", "ported"])
def test_plain_matches_pallas_v1(setup, source):
    _, jfpi, _, vels, corr = setup
    scan = pk.make_vco_scan(jfpi.params, T, interpret=True)
    jstate, ref = scan(jfpi.initial_state(), jnp.asarray(vels),
                       jnp.asarray(corr))
    state, out = _port_run(_port_params(setup, source), vels, corr)
    assert _max_abs(out, ref) <= TOL
    # v1 keeps the filtered SSP as state: the port's rows, projected
    fout = state.fout @ vs.output_projection(_port_params(setup, source))
    assert _max_abs(fout, jstate.fout) <= TOL


@pytest.mark.parametrize("source", ["carried", "ported"])
def test_plain_matches_pallas_v2(setup, source):
    """The production kernel, lane-padded to 128 oscillators; its params
    and final state are carried across with the padding dropped."""
    _, jfpi, _, vels, corr = setup
    padded = pk.pad_vco_params_to_lanes(jfpi.params)
    kp = padded.bias.shape[1]
    assert kp == 128
    z = jnp.zeros
    jstate0 = pk.VCOState(z((N_NEURONS, kp)), z((N_NEURONS, kp)), z((1, kp)),
                          z((1, kp)), z((1, kp)), z((1, 2 * kp)))
    scan = pk.make_vco_scan_v2(padded, T, interpret=True)
    jstate, ref = scan(jstate0, jnp.asarray(vels), jnp.asarray(corr))

    params = (vs.vco_params_from_numpy(*_jax_arrays(padded), device="cpu")
              if source == "carried" else _port_params(setup, source))
    state, out = _port_run(params, vels, corr)
    assert _max_abs(out, ref) <= TOL
    carried = vs.vco_state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in pk.VCOState._fields},
        params.bias.shape[1], device="cpu")
    for name in ("f0", "f1", "f2", "fout"):
        got, want = getattr(state, name), getattr(carried, name)
        assert got.shape == want.shape
        assert _max_abs(got, want) <= TOL, name


def test_reference_step_matches_jax(setup):
    _, jfpi, tfpi, vels, corr = setup
    jstate = jfpi.initial_state()
    state = tfpi.initial_state()
    for t in range(T):
        jstate, jy = pk.vco_reference_step(jfpi.params, jstate, vels[t],
                                           corr[t])
        state, y = vs.vco_reference_step(tfpi.params, state, vels[t],
                                         corr[t])
        assert y.shape == (jfpi.d,)
        assert _max_abs(y, jy) <= TOL


def test_params_from_numpy_drops_lane_padding(setup):
    _, jfpi, _, _, _ = setup
    plain = vs.vco_params_from_numpy(*_jax_arrays(jfpi.params), device="cpu")
    arrays, consts = _jax_arrays(pk.pad_vco_params_to_lanes(jfpi.params))
    padded = vs.vco_params_from_numpy(arrays, consts, device="cpu")
    for f in vs.ARRAY_FIELDS:
        assert torch.equal(getattr(padded, f), getattr(plain, f)), f
        assert getattr(padded, f).is_contiguous()
    assert padded.bias.shape == (N_NEURONS, 13)
    arrays = dict(arrays)
    arrays["drec0"] = arrays["drec0"].copy()
    arrays["drec0"][0, 100] = 1.0
    with pytest.raises(ValueError, match="drec0"):
        vs.vco_params_from_numpy(arrays, consts, device="cpu")


def test_cpu_tensors_take_the_plain_version(setup):
    _, _, tfpi, vels, corr = setup
    before = vs.vco_scan.launches
    s1, y1 = vs.vco_scan(tfpi.params, tfpi.initial_state(),
                         torch.tensor(vels), torch.tensor(corr))
    s2, y2 = _port_run(tfpi.params, vels, corr)
    assert torch.equal(y1, y2)
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    assert vs.vco_scan.launches == before


@pytest.mark.parametrize("n, k, num_sms, want", [
    (800, 49, 132, 4),    # the main path: 196 CTAs, at most two per SM
    (32, 49, 132, 4),     # the per-step floor's width
    (800, 62, 132, 4),    # the last k at which clusters of 4 measured faster
    (800, 63, 132, 1),    # k > 62: one CTA per oscillator
    (800, 53, 114, 4),    # the same edge on 114 SMs
    (800, 54, 114, 1),
    (800, 101, 132, 1),   # 3-D ssp_dim 201
    (800, 401, 132, 1),   # 3-D ssp_dim 801
    (3, 49, 132, 1),      # no CTA without a neuron
    (1, 13, 132, 1),
])
def test_cluster_size(n, k, num_sms, want):
    assert vs._cluster_size(n, k, num_sms) == want
    assert want in vs.CLUSTER_SIZES


def test_cpu_path_never_builds_the_kernel(setup, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the CUDA kernel")
    for name in ("build_vco_kernel", "_load", "_vco_scan_cuda"):
        monkeypatch.setattr(vs, name, refuse)
    _, _, tfpi, vels, corr = setup
    _, y = vs.vco_scan(tfpi.params, tfpi.initial_state(),
                       torch.tensor(vels), torch.tensor(corr))
    assert y.shape == (T, tfpi.d) and y.device.type == "cpu"


def test_chunks_carry_state(setup):
    _, _, tfpi, vels, corr = setup
    state = tfpi.initial_state()
    outs = []
    for lo in (0, 15, 30):
        state, y = vs.vco_scan(tfpi.params, state,
                               torch.tensor(vels[lo:lo + 15]),
                               torch.tensor(corr[lo:lo + 15]))
        outs.append(y)
    _, whole = _port_run(tfpi.params, vels, corr)
    assert _max_abs(torch.cat(outs), whole) <= 1e-6


def test_other_devices_raise(setup):
    _, _, tfpi, _, _ = setup
    params = tfpi.params._replace(
        **{f: getattr(tfpi.params, f).to("meta") for f in vs.ARRAY_FIELDS})
    state = vs.initial_vco_state(N_NEURONS, tfpi.k, device="meta")
    with pytest.raises(ValueError, match="no path"):
        vs.vco_scan(params, state, torch.zeros((5, 2), device="meta"),
                    torch.zeros((5, tfpi.d), device="meta"))
