"""The path-integration slice end to end: the port's FastPathIntegrator on
the CPU against the JAX FastPathIntegrator (Pallas kernel in interpret
mode) and against the JAX generic Simulator, as tests/test_pallas.py
checks the JAX fast path.

Tolerance: 5e-3 max-abs over 300 steps, tests/test_pallas.py's spike-flip
allowance; the constant-velocity decode error must stay below 0.25.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sspslam_tpu import HexagonalSSPSpace as JaxHexagonalSSPSpace
from sspslam_tpu.models import PathIntegration as JaxPathIntegration
from sspslam_tpu.models.fast_pathint import (
    FastPathIntegrator as JaxFastPathIntegrator)
from sspslam_tpu.nef import LIF, Connection, Network, Node, Probe, Simulator

from sspslam_tpu_torch import FastPathIntegrator, HexagonalSSPSpace
from sspslam_tpu_torch.nef import builder

SLICE_TOL = 5e-3
ACCURACY_TOL = 0.25
REPO = Path(__file__).resolve().parents[1]


def _spaces():
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    kw = dict(ssp_dim=31, seed=0, length_scale=0.3, domain_bounds=bounds)
    return JaxHexagonalSSPSpace(2, **kw), HexagonalSSPSpace(2, **kw)


@pytest.fixture(scope="module")
def traffic():
    js, ts = _spaces()
    T_steps = 300
    rng = np.random.default_rng(1)
    vels = (0.05 * rng.normal(size=(T_steps, 2))).astype(np.float32)
    ssp0 = js.encode(np.array([[0.15, -0.1]])).ravel()
    corr = np.zeros((T_steps, js.ssp_dim), np.float32)
    corr[:49] = ssp0   # the initial clamp (t < 0.05, i.e. steps 1..49)
    return js, ts, vels, ssp0, corr


@pytest.fixture(scope="module")
def port_out(traffic):
    _, ts, vels, _, corr = traffic
    fpi = FastPathIntegrator(ts, 48, seed=0, chunk_steps=100, device="cpu")
    return fpi.run(vels, corr)


def test_matches_jax_fast_path(traffic, port_out):
    js, _, vels, _, corr = traffic
    jfpi = JaxFastPathIntegrator(js, 48, seed=0, chunk_steps=100,
                                 interpret=True)
    ref = jfpi.run(vels, corr)
    assert port_out.shape == ref.shape == (300, js.ssp_dim)
    assert np.max(np.abs(port_out - ref)) <= SLICE_TOL


def test_matches_jax_generic_engine(traffic, port_out):
    js, _, vels, ssp0, _ = traffic
    T_steps, d = vels.shape[0], js.ssp_dim
    with Network(seed=0) as net:
        vel_n = Node(lambda t: vels[min(int(round((t - 0.001) / 0.001)),
                                        T_steps - 1)])
        init_n = Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
        pi = JaxPathIntegration(js, 48, 0.05, neuron_type=LIF())
        Connection(vel_n, pi.velocity_input, synapse=None)
        Connection(init_n, pi.input, synapse=None)
        p = Probe(pi.output, synapse=0.05)
    sim = Simulator(net, seed=0)
    sim.run_steps(T_steps)
    assert np.max(np.abs(port_out - sim.data[p])) <= SLICE_TOL


def test_device_solve_build_matches(traffic, port_out, monkeypatch):
    """The full-width build route (VCO decoders solved on the device, in
    float32) gives the same trajectory within the slice tolerance."""
    _, ts, vels, _, corr = traffic
    monkeypatch.setattr(builder, "DEVICE_SOLVE_MIN_BATCH_ELEMS", 0)
    fpi = FastPathIntegrator(ts, 48, seed=0, chunk_steps=100, device="cpu")
    assert np.max(np.abs(fpi.run(vels, corr) - port_out)) <= SLICE_TOL


def test_integration_accuracy():
    """A constant velocity is integrated to the right place."""
    _, space = _spaces()
    d = space.ssp_dim
    v = np.array([0.2, -0.1])
    scale = 1 / np.max(np.abs(space.phase_matrix @ v.reshape(2, 1)))
    T_steps = 800
    vels = np.tile(v * scale, (T_steps, 1)).astype(np.float32)
    corr = np.zeros((T_steps, d), np.float32)
    corr[:50] = space.encode(np.zeros((1, 2))).ravel()
    fpi = FastPathIntegrator(space, 300, seed=3, scaling_factor=scale,
                             chunk_steps=200, device="cpu")
    out = fpi.run(vels, corr)
    dec = space.decode(out[-1][None, :], num_samples=50, device="cpu")
    assert np.linalg.norm(dec - v * T_steps * 0.001) < ACCURACY_TOL


def test_run_without_transfer_keeps_chunks(traffic, port_out):
    _, ts, vels, _, corr = traffic
    fpi = FastPathIntegrator(ts, 48, seed=0, chunk_steps=128, device="cpu")
    outs = fpi.run(vels, corr, transfer=False)
    assert [o.shape[0] for o in outs] == [128, 128, 44]
    assert all(torch.is_tensor(o) and o.device.type == "cpu" for o in outs)
    np.testing.assert_allclose(torch.cat(outs).numpy(), port_out, atol=1e-6)


def test_port_imports_no_jax():
    code = ("import sys, sspslam_tpu_torch, sspslam_tpu_torch.models, "
            "sspslam_tpu_torch.ops.vco_scan; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'sspslam_tpu.')) or "
            "m == 'sspslam_tpu']; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    _, ts = _spaces()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastPathIntegrator(ts, 48, seed=0, device="cuda")
