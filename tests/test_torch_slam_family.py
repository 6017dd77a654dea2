"""The rest of the SLAM model family on the CPU against the JAX package:
the Newton and MLP clean-ups, SLAMNetwork with the direct-optim clean-up,
SLAMGatedNetwork (both gate semantics), SLAMViewNetwork (the reference
gate, and the auto-recovery gate with the anchor channels), the view
adapter, and the run_slamview and ``run_slam --backend gated`` CLIs.

Tolerances:
- the clean-ups on 32 noisy SSPs at ssp_dim 97 (float32 argmax,
  SSPSLAM_CLEANUP_F32=1 on both sides; the JAX functions vmapped, not
  jitted): 1e-4 (the Newton polish's maximiser is fixed only to the
  float32 resolution of its objective, see tests/test_torch_algebra.py;
  the JAX function called row by row and vmapped differ by 7e-5 here);
- built parameters: bitwise (the port also hoists the Newton and MLP
  tables, which the JAX package keeps in closures: those come from the
  port's own build, tests/torch_parity.py's with_port_hoisted);
- the networks through both executors, 300 steps of LIF: the spike-flip
  bounds of tests/torch_parity.py (an internal population over the first
  150 steps, see test_network_runs_match_jax);
- the view adapter's tables: 1e-6;
- the CLIs' traces: the spike-flip bounds.

The JAX side is built with SSPSLAM_HOIST_CLEANUP=1 and SSPSLAM_HOIST_GATE=1
so the parameter trees share the port's layout.
"""

import glob
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, step_both

import sspslam_tpu as jsp
import sspslam_tpu.models as jmodels
import sspslam_tpu.nef as jnef
from sspslam_tpu.models import slam as jslam

import sspslam_tpu_torch as psp
import sspslam_tpu_torch.models as pmodels
import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.models import slam as pslam

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ((jsp, jmodels, jnef), (psp, pmodels, pnef))
BOUNDS = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
D, N_LM, VIEW_RAD, STEPS = 25, 3, 0.8, 300
CLEANUP_TOL = 1e-4
TABLE_TOL = 1e-6


@pytest.fixture(autouse=True)
def hoisted_f32(monkeypatch):
    for name in ("SSPSLAM_HOIST_CLEANUP", "SSPSLAM_HOIST_GATE",
                 "SSPSLAM_CLEANUP_F32"):
        monkeypatch.setenv(name, "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space(sp, d=D):
    return sp.HexagonalSSPSpace(2, ssp_dim=d, seed=0, length_scale=0.3,
                                domain_bounds=BOUNDS)


def _world():
    dt = 0.001
    ts = dt * np.arange(STEPS)
    path = 0.6 * np.stack([np.sin(2 * np.pi * ts / 0.6),
                           np.cos(2 * np.pi * ts / 0.6)], 1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = np.random.default_rng(0).uniform(-0.7, 0.7, (N_LM, 2))
    return path, vels, landmarks, landmarks[None] - path[:, None]


def _decoder(space):
    """Random MLP decoder parameters (the networks' parity does not need a
    trained one)."""
    rng = np.random.default_rng(1)
    d, n = space.ssp_dim, space.domain_dim
    return [(0.3 * rng.normal(size=s)).astype(np.float32)
            for s in ((d, d), (d,), (d, 8), (8,), (8, n), (n,))]


# ---------------------------------------------------------------------------
# (1) the Newton and MLP clean-ups
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cleanup_spaces():
    """ssp_dim 97 spaces, the JAX-trained decoder carried across."""
    js, ps = _space(jsp, 97), _space(psp, 97)
    js.train_decoder_net(n_training_pts=20000, n_epochs=20, batch_size=256,
                         load_file=False, save_file=False)
    ps.decoder_params = [np.asarray(p) for p in js.decoder_params]
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (32, 2))
    q = (js.encode(x) + 0.03 * rng.normal(size=(32, js.ssp_dim))
         ).astype(np.float32)
    return js, ps, q


@pytest.mark.parametrize("method", ["direct-optim", "network",
                                    "network-optim"])
def test_cleanup_fun_matches_jax(method, cleanup_spaces):
    js, ps, q = cleanup_spaces
    jfun, jbank, jpts = jslam.make_cleanup_fun(js, method, 30)
    pfun, pbank, ppts = pslam.make_cleanup_fun(ps, method, 30)
    for a, b in ((pbank, jbank), (ppts, jpts)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    want = np.asarray(jax.vmap(jfun)(jnp.asarray(q)))
    consts = pslam._consts_on(pfun.hoisted_consts, "cpu")
    for got in (pfun(torch.as_tensor(q)),            # the closure, batched
                pfun(torch.as_tensor(q), consts),    # the hoisted tables
                torch.stack([pfun(torch.as_tensor(v), consts) for v in q])):
        np.testing.assert_allclose(got.numpy(), want, atol=CLEANUP_TOL)
    assert newton_iters_default() == 8


def newton_iters_default():
    import inspect
    return inspect.signature(pslam.make_cleanup_fun).parameters[
        "newton_iters"].default


def test_direct_optim_beats_coarse_grid():
    """tests/test_slam.py's oracle on the port: the polish lands closer to
    the true SSP than the coarse 12-per-axis grid snap."""
    space = _space(psp, 97)
    grid_f, _, _ = pslam.make_cleanup_fun(space, "grid", 12)
    opt_f, _, _ = pslam.make_cleanup_fun(space, "direct-optim", 12,
                                         newton_iters=10)
    phi = space.encode(np.array([[0.313, -0.547]]))[0]
    noisy = phi + 0.05 * np.random.default_rng(0).normal(size=phi.shape)
    x = torch.as_tensor(noisy, dtype=torch.float32)
    sim_grid = float(grid_f(x).numpy() @ phi)
    sim_opt = float(opt_f(x).numpy() @ phi)
    assert sim_opt > sim_grid and sim_opt > 0.98


# ---------------------------------------------------------------------------
# (2) the networks: built parameters, then both executors
# ---------------------------------------------------------------------------

def _feed(nef, pairs):
    for f, dst in pairs:
        nef.Connection(nef.Node(f), dst, synapse=None)


def _slam_direct_optim(sp, models, nef):
    space = _space(sp)
    path, vels, _, vec = _world()
    lm_space = sp.SPSpace(N_LM, D, seed=0)
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        models.get_slam_input_functions(space, lm_space, vels, vec, VIEW_RAD)
    with nef.Network(seed=0) as net:
        slam = models.SLAMNetwork(
            space, lm_space, VIEW_RAD, N_LM, pi_n_neurons=80,
            mem_n_neurons=90, circonv_n_neurons=30, vel_scaling_factor=scale,
            cleanup_samples_per_dim=30, seed=0,
            clean_up_method="direct-optim")
        _feed(nef, ((vel_f, slam.velocity_input),
                    (nef.clamp_table(space.encode(path[:1])[0], 0.05),
                     slam.pathintegrator.input),
                    (sp_f, slam.landmark_id_input),
                    (vecssp_f, slam.landmark_vec_ssp),
                    (in_view_f, slam.no_landmark_in_view)))
        nef.Probe(slam.output, synapse=0.05)
        nef.Probe(slam.gridcells)
        nef.Probe(slam.update_state)
    return net


def _slam_gated(sp, models, nef, gate_semantics):
    space = _space(sp)
    path, vels, _, vec = _world()
    lm_space = sp.SPSpace(N_LM, D, seed=0)
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        models.get_slam_input_functions(space, lm_space, vels, vec, VIEW_RAD)
    with nef.Network(seed=0) as net:
        slam = models.SLAMGatedNetwork(
            space, lm_space, VIEW_RAD, N_LM, pi_n_neurons=80,
            mem_n_neurons=90, circonv_n_neurons=30, dotprod_n_neurons=30,
            vel_scaling_factor=scale, seed=0, gate_semantics=gate_semantics)
        _feed(nef, ((vel_f, slam.velocity_input),
                    (nef.clamp_table(space.encode(path[:1])[0], 0.05),
                     slam.pathintegrator.input),
                    (sp_f, slam.landmark_sp_input),
                    (vecssp_f, slam.landmark_vecssp_input),
                    (in_view_f, slam.no_landmark_in_view)))
        nef.Probe(slam.output, synapse=0.05)
        nef.Probe(slam.threshold, synapse=0.01)
        nef.Probe(slam.correction, synapse=0.01)
    return net


def _slam_view(sp, models, nef, gate_mode, anchor=False,
               method="grid"):
    space = _space(sp)
    path, vels, landmarks, vec = _world()
    lm_space = sp.SPSpace(N_LM, D, seed=0)
    vel_f, scale, in_view_f, view_f = models.get_slamview_input_functions(
        space, lm_space, vels, vec, VIEW_RAD)
    if method.startswith("network"):
        space.decoder_params = _decoder(space)
    with nef.Network(seed=0) as net:
        slam = models.SLAMViewNetwork(
            space, lm_space, VIEW_RAD, N_LM, pi_n_neurons=80,
            mem_n_neurons=90, circonv_n_neurons=30, vel_scaling_factor=scale,
            cleanup_samples_per_dim=30, seed=0, gate_mode=gate_mode,
            anchor=anchor, clean_up_method=method,
            gate_kwargs=dict(ema_tau=0.01, cons_ema_tau=0.01,
                             recovery_T=0.06) if anchor else None)
        _feed(nef, ((vel_f, slam.velocity_input),
                    (nef.clamp_table(space.encode(path[:1])[0], 0.05),
                     slam.pathintegrator.input),
                    (view_f, slam.view_input),
                    (in_view_f, slam.no_landmark_in_view)))
        if anchor:
            _feed(nef, zip(models.get_anchor_input_functions(
                space, vec, [0, 1], landmarks[:2], VIEW_RAD),
                (slam.anchor_pos_input, slam.anchor_vec_ssp,
                 slam.no_anchor_in_view)))
        nef.Probe(slam.output, synapse=0.05)
        nef.Probe(slam.update_state)
        nef.Probe(slam.assomemory.recall, synapse=0.01)
    return net


NETWORKS = {
    "slam-direct-optim": _slam_direct_optim,
    "gated-loihi": lambda *pk: _slam_gated(*pk, "loihi"),
    "gated-matched": lambda *pk: _slam_gated(*pk, "matched"),
    "view-reference": lambda *pk: _slam_view(*pk, "reference"),
    "view-auto-anchor": lambda *pk: _slam_view(*pk, "auto_recovery",
                                               anchor=True),
}


@pytest.mark.parametrize("name", list(NETWORKS))
def test_network_runs_match_jax(name):
    """Built parameters bitwise, then both executors on the JAX weights
    for 300 LIF steps, within the spike-flip bounds: the PI output and the
    gate (or the neural threshold) over all 300 steps, the third probe (an
    internal population: the memory's recall, or the gated network's
    correction population) over the first 150.  Past that, in the view
    network and the 'matched' gate, one flipped spike is carried on by PES
    learning or by the open gate's feedback loop and the two populations'
    spike trains part for good (measured at these widths from step ~150),
    while the outputs stay within the bounds."""
    jnet, pnet = [NETWORKS[name](*pk) for pk in PACKAGES]
    jout, pout, *_ = step_both(jnet, pnet, STEPS, seed=0, check_params=True)
    assert sorted(jout) == sorted(pout) and len(jout) == 3
    for i, k in enumerate(sorted(jout)):
        n = STEPS if i < 2 else STEPS // 2
        assert_close(pout[k][:n], jout[k][:n], spiking=True,
                     what=f"{name} probe {i}")
    assert np.abs(pout[min(pout)][-1]).max() > 0.05


def test_gated_network_has_no_node_function():
    """SLAMGatedNetwork is all-neural: no node of it computes in the step
    (every node is an input, a constant or a pass-through)."""
    from sspslam_tpu_torch.nef.builder import build
    model = build(NETWORKS["gated-loihi"](psp, pmodels, pnef), seed=0,
                  device="cpu")
    kinds = {info["kind"] for info in model.node_info.values()}
    assert "jnp_func" not in kinds and model.hoisted == {}
    assert pmodels.SLAMLoihiNetwork is pmodels.SLAMGatedNetwork


def test_view_network_options():
    """Every clean-up method builds (the MLP ones from a given decoder), the
    grid-cell wiring builds, and the anchor needs the auto gate."""
    space = _space(psp)
    space.decoder_params = _decoder(space)
    lm = psp.SPSpace(N_LM, D, seed=0)
    for method in ("grid", "direct-optim", "network", "network-optim", None):
        net = pmodels.SLAMViewNetwork(space, lm, 0.6, N_LM, 80, 90, 30,
                                      clean_up_method=method,
                                      cleanup_samples_per_dim=10, seed=0)
        assert (net.clean_up_fun is None) == (method is None)
    net = pmodels.SLAMViewNetwork(space, lm, 0.6, N_LM, 80, 90, 30,
                                  gc_n_neurons=40,
                                  cleanup_samples_per_dim=10, seed=0)
    assert isinstance(net.gridcells, pnef.Ensemble)
    with pytest.raises(ValueError, match="anchor"):
        pmodels.SLAMViewNetwork(space, lm, 0.6, N_LM, 80, 90, 30,
                                anchor=True, cleanup_samples_per_dim=10)


def test_slamview_adapter_matches_jax():
    _, vels, _, vec = _world()
    outs = [models.get_slamview_input_functions(
        _space(sp), sp.SPSpace(N_LM, D, seed=0), vels, vec, 0.3)
        for sp, models, _ in PACKAGES]
    (jv, js, jin, jview), (pv, ps, pin, pview) = outs
    assert ps == js
    for p, j in ((pv, jv), (pin, jin), (pview, jview)):
        np.testing.assert_allclose(p.values, j.values, atol=TABLE_TOL)
    assert (pin.values == 0).any() and (pin.values > 0).any()


# ---------------------------------------------------------------------------
# (3) the CLIs
# ---------------------------------------------------------------------------

CLI_ARGS = ["--T", "0.3", "--limit", "2", "--ssp-dim", "25",
            "--pi-n-neurons", "80", "--mem-n-neurons", "90",
            "--circonv-n-neurons", "30", "--n-landmarks", "5", "--save"]
# name: (the port's module and flags, the JAX CLI's script and flags)
CLIS = {
    "slamview": (("run_slamview", "--device", "cpu"),
                 ("run_slamview.py", "--backend", "cpu")),
    "slam-gated": (("run_slam", "--backend", "gated", "--device", "cpu"),
                   ("run_slam.py", "--backend", "gated")),
}


def test_clis_match_jax(tmp_path):
    """The port's run_slamview and run_slam --backend gated on the CPU
    against the JAX CLIs: the JAX CLIs run as children (one thread each)
    while the port's ``main`` runs in this process, as ``python -m`` calls
    it; the same saved world, traces within the spike-flip bounds, the
    same lines."""
    import contextlib
    import importlib
    import io
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               SSPSLAM_CLEANUP_F32="1", OMP_NUM_THREADS="1")
    runs = {(name, side): tmp_path / f"{name}-{side}"
            for name in CLIS for side in ("port", "jax")}
    procs = {name: subprocess.Popen(
        [sys.executable, str(REPO / "experiments" / jax_cli[0]),
         *jax_cli[1:], *CLI_ARGS, "--save-dir", str(runs[name, "jax"])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, (_, jax_cli) in CLIS.items()}
    stdout = {}
    for name, ((module, *flags), _) in CLIS.items():
        cli = importlib.import_module(f"sspslam_tpu_torch.experiments."
                                      f"{module}")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli.main([*flags, *CLI_ARGS, "--save-dir",
                      str(runs[name, "port"])])
        stdout[name, "port"] = out.getvalue()
    for name, proc in procs.items():
        stdout[name, "jax"], stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])
    res = {}
    for key, run in runs.items():
        (path,) = glob.glob(str(run / "*.npz"))
        res[key] = (stdout[key], np.load(path, allow_pickle=True))
    for name in CLIS:
        (pout, port), (jout, ref) = res[name, "port"], res[name, "jax"]
        assert sorted(port.files) == sorted(ref.files)
        np.testing.assert_array_equal(port["path"], ref["path"])
        np.testing.assert_array_equal(port["obj_locs"], ref["obj_locs"])
        assert port["slam_sim_out"].shape == (300, 25)
        assert_close(port["slam_sim_out"], ref["slam_sim_out"],
                     spiking=True, what=f"{name} slam_sim_out")
        for prefix in ("compile:", "sim wall time:", "final distance error:",
                       "saved "):
            for out in (pout, jout):
                assert any(line.startswith(prefix)
                           for line in out.splitlines()), (name, prefix)
        if name == "slam-gated":
            assert port["landmark_ssps_est"].size == 0
            assert not any(line.startswith("learned-map")
                           for line in pout.splitlines())


def test_run_slamview_and_numpy_backend_plot_write_figures(tmp_path,
                                                           monkeypatch):
    """On the CPU ``run_slamview --plot`` writes
    ``figures/slamview_<seed>.png`` and ``run_slam --backend numpy --plot``
    (the NumPy interpreter's run) ``figures/slam_numpy.png`` under the
    working directory, the JAX CLIs' figures."""
    from torch_parity import run_port_cli
    monkeypatch.chdir(tmp_path)
    for module, flags, png in (
            ("run_slamview", ["--device", "cpu"], "slamview_0.png"),
            ("run_slam", ["--backend", "numpy", "--device", "cpu"],
             "slam_numpy.png")):
        _, out = run_port_cli(module, [*flags, "--plot", *CLI_ARGS,
                                       "--save-dir", "data"])
        path = tmp_path / "figures" / png
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", module
        assert out.splitlines()[-1] == f"saved figures/{png}", module
