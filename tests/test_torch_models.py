"""The port's models, SSP spaces, binding algebra and run_pathint CLI on the
CPU against the JAX package: PathIntegration through both Simulators,
CircularConvolution and AssociativeMemory step by step, the SSP spaces and
vsa functions bitwise or within 1e-6, the CLI's saved trace within 1e-4;
and the port's entry points default to the card.
"""

import glob
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, assert_runs_match

import sspslam_tpu as jsp
import sspslam_tpu.models as jmodels
import sspslam_tpu.nef as jnef
from sspslam_tpu.ops import vsa as jvsa

import sspslam_tpu_torch as psp
import sspslam_tpu_torch.models as pmodels
import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.ops import vsa as pvsa

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ((jsp, jmodels, jnef), (psp, pmodels, pnef))
BOUNDS = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))


def _pi(sp, models, nef, nt, with_gcs=False, n_steps=300):
    dt = 0.001
    ts = dt * np.arange(n_steps)
    path = 0.4 * np.stack([np.sin(2 * np.pi * ts / 0.3),
                           np.cos(2 * np.pi * ts / 0.3)], 1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    space = sp.HexagonalSSPSpace(2, ssp_dim=31, seed=0, length_scale=0.3,
                                 domain_bounds=BOUNDS)
    scale = 1 / np.max(np.abs(space.phase_matrix @ vels.T))
    init = space.encode(path[:1]).flatten()
    with nef.Network(seed=0) as net:
        vel = nef.Node(nef.TimeTable(vels * scale, dt))
        ini = nef.Node(lambda t: init if t < 0.05
                       else np.zeros(space.ssp_dim))
        pi = models.PathIntegration(space, 48, 0.05, scaling_factor=scale,
                                    stable=True, neuron_type=nt(nef),
                                    with_gcs=with_gcs, n_gcs=60)
        nef.Connection(vel, pi.velocity_input, synapse=None)
        nef.Connection(ini, pi.input, synapse=None)
        p = nef.Probe(pi.output, synapse=0.05)
    return net, p


@pytest.mark.parametrize("nt,with_gcs,spiking", [
    (lambda nef: nef.LIFRate(), False, False),
    (lambda nef: nef.LIF(), False, True),
    (lambda nef: nef.LIFRate(), True, False),
], ids=["lifrate", "lif", "lifrate-gcs"])
def test_pathintegration_through_both_simulators(nt, with_gcs, spiking):
    (jnet, jp), (pnet, pp) = [_pi(*pk, nt, with_gcs) for pk in PACKAGES]
    jsim = jnef.Simulator(jnet, seed=0)
    jsim.run_steps(300)
    psim = pnef.Simulator(pnet, seed=0, device="cpu")
    psim.run_steps(300)
    assert_close(psim.data[pp], jsim.data[jp], spiking=spiking)


def test_circular_convolution():
    d = 8

    def make(models, nef):
        rng = np.random.default_rng(0)
        a, b = rng.normal(size=(2, d)) / np.sqrt(d)
        with nef.Network(seed=5) as net:
            cc = models.CircularConvolution(30, d, seed=5,
                                            neuron_type=nef.LIFRate())
            nef.Connection(nef.Node(lambda t: a), cc.input_a, synapse=None)
            nef.Connection(nef.Node(lambda t: b), cc.input_b, synapse=None)
            nef.Probe(cc.output, synapse=0.01)
        return net
    (_, jm, jn), (_, pm, pn) = PACKAGES
    jout, pout, *_ = assert_runs_match(make(jm, jn), make(pm, pn), 100,
                                       seed=5)
    assert np.abs(pout[0][-1]).max() > 0.01


def test_associative_memory():
    def make(models, nef):
        with nef.Network(seed=7) as net:
            am = models.AssociativeMemory(60, 2, 2, intercept=0.3, seed=7,
                                          tau=0.01)
            nef.Connection(nef.Node(lambda t: np.array(
                [np.cos(4 * t), np.sin(4 * t)])), am.key_input, synapse=None)
            nef.Connection(nef.Node(lambda t: np.array([0.5, -0.5])),
                           am.value_input, synapse=None)
            nef.Connection(nef.Node(lambda t: np.array(
                [0.0 if t < 0.1 else 5.0])), am.learning, synapse=None)
            nef.Probe(am.recall, synapse=0.01)
            nef.Probe(am.conn_in.learning_rule, attr="scaled_encoders")
        return net
    (_, jm, jn), (_, pm, pn) = PACKAGES
    assert_runs_match(make(jm, jn), make(pm, pn), 150, seed=7, spiking=True)


@pytest.mark.parametrize("make", [
    lambda sp: sp.RandomSSPSpace(2, ssp_dim=31, seed=3, length_scale=0.4,
                                 domain_bounds=BOUNDS),
    lambda sp: sp.RandomSSPSpace(3, ssp_dim=25, seed=4, sampler="norm"),
    lambda sp: sp.RectangularSSPSpace(2, ssp_dim=33, seed=5,
                                      domain_bounds=BOUNDS),
    lambda sp: sp.HexagonalSSPSpace(2, ssp_dim=31, seed=0,
                                    domain_bounds=BOUNDS),
], ids=["random-unif", "random-norm", "rectangular", "hexagonal"])
def test_ssp_spaces_bitwise(make):
    js, ps = make(jsp), make(psp)
    np.testing.assert_array_equal(ps.phase_matrix, js.phase_matrix)
    x = np.random.default_rng(0).uniform(-1, 1, (5, js.domain_dim))
    np.testing.assert_array_equal(ps.encode(x), np.asarray(js.encode(x)))
    if hasattr(js, "sample_grid_encoders"):
        np.testing.assert_array_equal(ps.sample_grid_encoders(20),
                                      js.sample_grid_encoders(20))


def test_spspace_bitwise():
    js, ps = jsp.SPSpace(6, 32, seed=2), psp.SPSpace(6, 32, seed=2)
    np.testing.assert_array_equal(ps.vectors, js.vectors)
    np.testing.assert_array_equal(ps.bind(ps.vectors[0], ps.vectors[1]),
                                  js.bind(js.vectors[0], js.vectors[1]))
    np.testing.assert_array_equal(ps.invert(ps.vectors), js.invert(js.vectors))
    np.testing.assert_array_equal(ps.decode(ps.vectors), js.decode(js.vectors))


def test_vsa_binding_algebra():
    rng = np.random.default_rng(1)
    for d in (31, 32):
        a, b = rng.normal(size=(2, 3, d))
        a, b = (v / np.linalg.norm(v, axis=-1, keepdims=True)  # unit, as SSPs
                for v in (a.astype(np.float32), b.astype(np.float32)))
        ta, tb = torch.as_tensor(a), torch.as_tensor(b)
        for name in ("bind", "unbind"):
            got = getattr(pvsa, name)(ta, tb).numpy()
            want = np.asarray(getattr(jvsa, name)(jnp.asarray(a),
                                                  jnp.asarray(b)))
            np.testing.assert_allclose(got, want, atol=1e-6)
        for name in ("invert", "normalize", "make_unitary"):
            got = getattr(pvsa, name)(ta).numpy()
            want = np.asarray(getattr(jvsa, name)(jnp.asarray(a)))
            np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_array_equal(
            pvsa.identity_vector(d, device="cpu").numpy(),
            np.asarray(jvsa.identity_vector(d)))
        for inv in ((False, False), (True, False), (False, True)):
            for p_, j_ in zip(pvsa.binding_input_transforms(d, *inv),
                              jvsa.binding_input_transforms(d, *inv)):
                np.testing.assert_array_equal(p_, j_)
        np.testing.assert_array_equal(pvsa.binding_output_transform(d),
                                      jvsa.binding_output_transform(d))
        for p_, j_ in zip(pvsa.dft_half_matrices(d),
                          jvsa.dft_half_matrices(d)):
            np.testing.assert_array_equal(p_, j_)
    # bind is circular convolution
    a, b = rng.normal(size=(2, 16))
    want = np.fft.ifft(np.fft.fft(a) * np.fft.fft(b)).real
    got = pvsa.bind(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9)


def _cli(cmd, out_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        cmd + ["--T", "0.5", "--limit", "2", "--ssp-dim", "31",
               "--pi-n-neurons", "100", "--neuron-type", "lifrate",
               "--save", "--save-dir", str(out_dir)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (path,) = glob.glob(str(out_dir / "*.npz"))
    return proc.stdout, np.load(path, allow_pickle=True)


def test_run_pathint_cli_matches_jax(tmp_path):
    """The port's CLI and the JAX CLI on the CPU save the same trace.
    (``--limit 2``: at the default 0.1 Hz a path shorter than 10 s is
    constant, its zero velocity scales to NaN and silences every VCO, so
    the two traces would agree trivially.)"""
    pout, port = _cli([sys.executable, "-m",
                       "sspslam_tpu_torch.experiments.run_pathint",
                       "--device", "cpu"], tmp_path / "port")
    jout, ref = _cli([sys.executable, str(REPO / "experiments" /
                                          "run_pathint.py"),
                      "--backend", "cpu"], tmp_path / "jax")
    assert sorted(port.files) == sorted(ref.files)
    assert port["pi_sim_out"].shape == ref["pi_sim_out"].shape == (500, 25)
    assert np.max(np.abs(port["pi_sim_out"] - ref["pi_sim_out"])) <= 1e-4
    np.testing.assert_array_equal(port["path"], ref["path"])
    np.testing.assert_allclose(port["pi_error"], ref["pi_error"], atol=1e-6)
    for prefix in ("compile:", "sim wall time:", "final distance error:",
                   "saved "):
        assert any(l.startswith(prefix) for l in pout.splitlines()), prefix


def test_entry_points_default_to_the_card():
    """Simulator, FastPathIntegrator and the CLIs name no device by default
    and then ask for CUDA: without a card they raise and never run on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    from sspslam_tpu_torch.experiments import run_pathint, run_slam
    space = psp.HexagonalSSPSpace(2, ssp_dim=31, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmodels.FastPathIntegrator(space, 48, seed=0)
    with pnef.Network(seed=0) as net:
        pnef.Probe(pnef.Node(lambda t: np.zeros(1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pnef.Simulator(net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pathint.main(["--T", "0.01", "--ssp-dim", "31",
                          "--pi-n-neurons", "20"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_slam.main(["--T", "0.01", "--ssp-dim", "31",
                       "--pi-n-neurons", "20", "--mem-n-neurons", "20",
                       "--circonv-n-neurons", "10", "--n-landmarks", "3"])


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|sspslam_tpu)"
                         r"(\s|\.|$)", re.M)
    files = sorted((REPO / "sspslam_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [str(f) for f in files if pattern.search(f.read_text())]
    assert not bad, bad
