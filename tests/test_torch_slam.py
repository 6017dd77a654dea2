"""The port's SLAM slice on the CPU against the JAX package: the clean-up
(float32 picks bitwise; bf16 picks within bf16 rounding of JAX's in
similarity), both correction gates step by step (outputs and state within
1e-5, the same trigger steps), the three input adapters (within 1e-6), the
built parameters (bitwise), SLAMNetwork through both executors on the same
weights (tests/torch_parity.py's spike-flip bounds) and the run_slam CLI
against the JAX CLI; and the repairs this slice needs: the DFT tables are
uploaded once per device, and a hoisted threshold changed in place changes
the next step.

The JAX side is built with SSPSLAM_HOIST_CLEANUP=1 and SSPSLAM_HOIST_GATE=1
so both parameter trees have the same keys (the port always carries the
clean-up bank and the gate thresholds as hoisted tables), and with
SSPSLAM_CLEANUP_F32=1 on both sides where the clean-up's argmax is compared.
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
from torch_parity import assert_runs_match, host_params, leaves

import sspslam_tpu as jsp
import sspslam_tpu.models as jmodels
import sspslam_tpu.nef as jnef
from sspslam_tpu.models import slam as jslam
from sspslam_tpu.nef import Simulator as JaxSimulator
from sspslam_tpu.ops import vsa as jvsa
from sspslam_tpu.utils import profiling as jprof

import sspslam_tpu_torch as psp
import sspslam_tpu_torch.models as pmodels
import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.models import slam as pslam
from sspslam_tpu_torch.nef.builder import build as port_build
from sspslam_tpu_torch.nef.executor import build_params, params_from_numpy
from sspslam_tpu_torch.ops import vsa as pvsa
from sspslam_tpu_torch.utils import profiling as pprof

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ((jsp, jmodels, jnef), (psp, pmodels, pnef))
BOUNDS = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
D, N_LM, VIEW_RAD, STEPS = 25, 3, 0.8, 300
GATE_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's small CPU ops run fastest on one thread (more only
    contend); restored afterwards for the other files of this worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def hoisted_f32(monkeypatch):
    """The JAX package's hoisted layout, float32 clean-up on both sides."""
    for name in ("SSPSLAM_HOIST_CLEANUP", "SSPSLAM_HOIST_GATE",
                 "SSPSLAM_CLEANUP_F32"):
        monkeypatch.setenv(name, "1")


def _space(sp):
    return sp.HexagonalSSPSpace(2, ssp_dim=D, seed=0, length_scale=0.3,
                                domain_bounds=BOUNDS)


def _world(n_steps=STEPS, rigid=True):
    """A looping path, its velocities and N_LM landmarks; ``rigid=False``
    jitters each landmark's displacement on its own."""
    dt = 0.001
    ts = dt * np.arange(n_steps)
    path = 0.6 * np.stack([np.sin(2 * np.pi * ts / 0.6),
                           np.cos(2 * np.pi * ts / 0.6)], 1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    rng = np.random.default_rng(0)
    landmarks = rng.uniform(-0.7, 0.7, (N_LM, 2))
    vec = landmarks[None] - path[:, None]
    if not rigid:
        vec = vec + 0.01 * rng.normal(size=vec.shape)
    return path, vels, landmarks, vec


def _slam(sp, models, nef, gate_mode="reference", anchor=False, gc=0,
          update_thres=0.2):
    """A small SLAMNetwork fed by the single-nearest adapter; returns the
    network and its probes (PI output, gate output, recall)."""
    space = _space(sp)
    path, vels, landmarks, vec = _world()
    lm_space = sp.SPSpace(N_LM, D, seed=0)
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        models.get_slam_input_functions(space, lm_space, vels, vec, VIEW_RAD)
    init = space.encode(path[:1]).ravel()
    with nef.Network(seed=0) as net:
        slam = models.SLAMNetwork(
            space, lm_space, VIEW_RAD, N_LM, pi_n_neurons=80,
            mem_n_neurons=90, circonv_n_neurons=30, vel_scaling_factor=scale,
            cleanup_samples_per_dim=30, seed=0, gate_mode=gate_mode,
            anchor=anchor, gc_n_neurons=gc, update_thres=update_thres)
        for f, dst in ((vel_f, slam.velocity_input),
                       (nef.clamp_table(init, 0.05),
                        slam.pathintegrator.input),
                       (sp_f, slam.landmark_id_input),
                       (vecssp_f, slam.landmark_vec_ssp),
                       (in_view_f, slam.no_landmark_in_view)):
            nef.Connection(nef.Node(f), dst, synapse=None)
        if anchor:
            tables = models.get_anchor_input_functions(
                space, vec, [0, 1], landmarks[:2], VIEW_RAD)
            for f, dst in zip(tables, (slam.anchor_pos_input,
                                       slam.anchor_vec_ssp,
                                       slam.no_anchor_in_view)):
                nef.Connection(nef.Node(f), dst, synapse=None)
        probes = {"pi": nef.Probe(slam.output, synapse=0.05),
                  "gate": nef.Probe(slam.update_state),
                  "recall": nef.Probe(slam.assomemory.recall, synapse=0.01)}
    return net, probes, slam


# ---------------------------------------------------------------------------
# (1) the clean-up
# ---------------------------------------------------------------------------

def _queries(bank, rng):
    """Random vectors, and bank rows plus small noise."""
    rows = bank[rng.integers(0, len(bank), 16)]
    return np.concatenate([
        rng.normal(size=(16, bank.shape[1])) / np.sqrt(bank.shape[1]),
        rows + 0.01 * rng.normal(size=rows.shape)]).astype(np.float32)


def test_cleanup_float32_picks_jax_rows_bitwise(hoisted_f32):
    jfun, jbank, _ = jslam.make_cleanup_fun(_space(jsp), "grid", 30)
    pfun, pbank, _ = pslam.make_cleanup_fun(_space(psp), "grid", 30)
    np.testing.assert_array_equal(pbank, jbank)
    bank = np.asarray(pbank, np.float32)
    q = _queries(bank, np.random.default_rng(0))
    want = np.asarray(jvsa.cleanup_from_set(jnp.asarray(bank),
                                            jnp.asarray(q)))
    got = pvsa.cleanup_from_set(torch.as_tensor(bank), torch.as_tensor(q))
    np.testing.assert_array_equal(got.numpy(), want)
    for x in q:
        np.testing.assert_array_equal(pfun(torch.as_tensor(x)).numpy(),
                                      np.asarray(jfun(jnp.asarray(x))))
    # through the hoisted tables the step passes
    consts = pslam._consts_on(pfun.hoisted_consts, "cpu")
    assert consts["bank_sim"].dtype == torch.float32
    np.testing.assert_array_equal(pfun(torch.as_tensor(q), consts).numpy(),
                                  want)


def test_cleanup_bf16_pick_within_bf16_rounding_of_jax(monkeypatch):
    monkeypatch.delenv("SSPSLAM_CLEANUP_F32", raising=False)
    jfun, _, _ = jslam.make_cleanup_fun(_space(jsp), "grid", 30)
    pfun, bank, _ = pslam.make_cleanup_fun(_space(psp), "grid", 30)
    assert pfun.hoisted_consts["bank_sim"].dtype == torch.bfloat16
    bank = np.asarray(bank, np.float32)
    q = _queries(bank, np.random.default_rng(1))
    bsim = pfun.hoisted_consts["bank_sim"]
    for x in q:
        # both round the product's output to bf16, and agree on it
        jsims = jnp.einsum("md,d->m", jnp.asarray(bank).astype(jnp.bfloat16),
                           jnp.asarray(x).astype(jnp.bfloat16))
        np.testing.assert_array_equal(
            pvsa.similarity(bsim, torch.as_tensor(x).bfloat16()).float()
            .numpy(), np.asarray(jsims.astype(jnp.float32)))
        got = pfun(torch.as_tensor(x)).numpy()
        want = np.asarray(jfun(jnp.asarray(x)))
        assert any(np.array_equal(got, r) for r in bank)
        # the two picks' float32 similarities differ by at most the bf16
        # rounding of the similarity (8 significant bits, both picks)
        sims = bank @ x
        tol = 2 * 2.0 ** -8 * np.abs(sims).max()
        assert abs(float(got @ x) - float(want @ x)) <= tol


def test_default_cleanup_dtype_follows_the_jax_switch(monkeypatch):
    monkeypatch.delenv("SSPSLAM_CLEANUP_F32", raising=False)
    assert pvsa.default_cleanup_dtype() is torch.bfloat16
    assert jvsa.default_cleanup_dtype() == jnp.bfloat16
    monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
    assert pvsa.default_cleanup_dtype() is torch.float32
    assert jvsa.default_cleanup_dtype() == jnp.float32


def test_cleanup_methods_not_ported_raise():
    """All four clean-up methods and None build (the MLP methods from a
    space given its decoder, as a CPU caller must); an unknown method
    raises ValueError."""
    space = _space(psp)
    assert pslam.make_cleanup_fun(space, None) == (None, None, None)
    rng = np.random.default_rng(0)
    space.decoder_params = [rng.normal(size=s).astype(np.float32)
                            for s in ((D, D), (D,), (D, 8), (8,), (8, 2),
                                      (2,))]
    x = torch.as_tensor(space.encode([[0.2, -0.3]])[0], dtype=torch.float32)
    for method in ("grid", "direct-optim", "network", "network-optim"):
        fun, _, _ = pslam.make_cleanup_fun(space, method, 30)
        out = fun(x)
        assert out.shape == (D,) and torch.isfinite(out).all(), method
    with pytest.raises(ValueError, match="clean_up_method"):
        pslam.make_cleanup_fun(space, "nearest")


# ---------------------------------------------------------------------------
# (2) the correction gates, step by step
# ---------------------------------------------------------------------------

def _gate_inputs(anchor, n=400, d=D, seed=0):
    """400 gate inputs that arm the gate (estimate agrees with PI on a
    familiar, consistent landmark), lose tracking (disagreement, then an
    inconsistent map), recover and expire (agreement again), and leave the
    view; with ``anchor`` a surveyed landmark comes and goes."""
    rng = np.random.default_rng(seed)

    def unit(k=1):
        v = rng.normal(size=(k, d))
        return v / np.linalg.norm(v, axis=1, keepdims=True)
    xs = []
    for i in range(n):
        pi = unit()[0]
        recall = unit()[0]
        if i < 100 or 250 <= i < 330:          # tracking
            pos, err = pi + 0.05 * unit()[0], 0.05 * unit()[0]
        elif i < 170:                           # disagreement
            pos, err = unit()[0], 0.05 * unit()[0]
        else:                                   # inconsistent map
            pos, err = pi + 0.05 * unit()[0], recall - unit()[0]
        no_view = 0.0 if i < 360 else 10.0
        parts = [pos, pi, recall, err]
        if anchor:
            seen = (i // 40) % 2 == 0
            anc_vec = unit()[0]
            anc_pos = (np.fft.ifft(np.fft.fft(pi) * np.fft.fft(anc_vec)).real
                       if i < 120 else unit()[0])
            parts += [anc_pos, anc_vec, [0.0 if seen else 10.0]]
        xs.append(np.concatenate(parts + [[no_view]]).astype(np.float32))
    return np.stack(xs)


GATE_KW = dict(dt=0.001, ema_tau=0.01, cons_ema_tau=0.01, recovery_T=0.06)


@pytest.mark.parametrize("anchor", [False, True], ids=["plain", "anchor"])
@pytest.mark.parametrize("recovery_decay", [True, False],
                         ids=["decay", "hold"])
@pytest.mark.parametrize("arm_at_start", [False, True],
                         ids=["arm-on-agreement", "armed"])
def test_auto_recovery_gate_matches_jax(anchor, recovery_decay,
                                        arm_at_start):
    kw = dict(GATE_KW, recovery_decay=recovery_decay,
              arm_at_start=arm_at_start, anchor=anchor)
    jgate = jslam.make_auto_recovery_gate_func(0.2, 0.1, D, **kw)
    jstep = jax.jit(jgate)
    pgate = pslam.make_auto_recovery_gate_func(0.2, 0.1, D, **kw)
    np.testing.assert_array_equal(pgate.state_init, jgate.state_init)
    assert pgate.hoisted_consts == jgate.hoisted_consts
    jc = {k: jnp.asarray(v) for k, v in jgate.hoisted_consts.items()}
    pc = pslam._consts_on(pgate.hoisted_consts, "cpu")
    js = jnp.asarray(jgate.state_init)
    ps = torch.as_tensor(pgate.state_init)
    R = GATE_KW["recovery_T"] / GATE_KW["dt"]
    j_trig, p_trig, timers = [], [], []
    for i, x in enumerate(_gate_inputs(anchor)):
        jo, js_new = jstep(0.0, jnp.asarray(x), js, jc)
        po, ps_new = pgate(torch.tensor(0.0), torch.as_tensor(x), ps, pc)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=GATE_TOL,
                                   err_msg=f"output, step {i}")
        np.testing.assert_allclose(ps_new.numpy(), np.asarray(js_new),
                                   atol=GATE_TOL, err_msg=f"state, step {i}")
        j_trig += [i] if float(js_new[2]) == R else []
        p_trig += [i] if float(ps_new[2]) == R else []
        timers.append(float(ps_new[2]))
        js, ps = js_new, ps_new
    assert p_trig == j_trig and p_trig, (p_trig, j_trig)
    # a recovery ran out: the timer came back to 0 after a trigger
    assert 0.0 in timers[p_trig[0]:], timers


def test_reference_gate_matches_jax():
    jfun = jslam.make_update_state_func(0.2, 0.1, D)
    pfun = pslam.make_update_state_func(0.2, 0.1, D)
    pc = pslam._consts_on(pfun.hoisted_consts, "cpu")
    fired = 0
    for x in _gate_inputs(False):
        x = np.concatenate([x[:2 * D], x[-1:]])
        want = np.asarray(jfun(0.0, jnp.asarray(x)))
        for consts in (pc, None):
            got = pfun(torch.tensor(0.0), torch.as_tensor(x), consts)
            np.testing.assert_allclose(got.numpy(), want, atol=GATE_TOL)
        fired += bool(np.any(want))
    assert 0 < fired < 400


# ---------------------------------------------------------------------------
# (3) the adapters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which,rigid", [
    ("get_slam_input_functions", True),
    ("get_slam_input_functions2", True),
    ("get_slam_input_functions2", False),
], ids=["single", "multi-rigid", "multi-nonrigid"])
def test_input_adapters_match_jax(which, rigid):
    _, vels, _, vec = _world(rigid=rigid)
    outs = [getattr(models, which)(_space(sp), sp.SPSpace(N_LM, D, seed=0),
                                   vels, vec, VIEW_RAD)
            for sp, models, _ in PACKAGES]
    (jv, js, *jrest), (pv, ps, *prest) = outs
    np.testing.assert_allclose(pv.values, jv.values, atol=1e-6)
    assert ps == js
    for j, p in zip(jrest, prest):
        if callable(j) and not hasattr(j, "values"):   # landmark_id_func
            for t in (0.001, 0.05, 0.2, 0.3, 1.0):
                np.testing.assert_array_equal(np.asarray(p(t)),
                                              np.asarray(j(t)))
        else:
            np.testing.assert_allclose(p.values, j.values, atol=1e-6)


def test_anchor_adapter_matches_jax():
    _, _, landmarks, vec = _world()
    outs = [models.get_anchor_input_functions(_space(sp), vec, [0, 2],
                                              landmarks[[0, 2]], 0.4)
            for sp, models, _ in PACKAGES]
    for j, p in zip(*outs):
        np.testing.assert_allclose(p.values, j.values, atol=1e-6)
    assert (outs[1][2].values == 0).any() and (outs[1][2].values > 0).any()
    for sp, models, _ in PACKAGES:
        with pytest.raises(ValueError, match="no surveyed landmarks"):
            models.get_anchor_input_functions(_space(sp), vec, [],
                                              landmarks[:0], VIEW_RAD)


# ---------------------------------------------------------------------------
# (4) the built parameters, (5) both executors on the same weights
# ---------------------------------------------------------------------------

MODES = {"reference": dict(), "auto-anchor": dict(
    gate_mode="auto_recovery", anchor=True), "gridcells": dict(gc=40)}


@pytest.mark.parametrize("mode", list(MODES))
def test_build_params_equal_jax(mode, hoisted_f32):
    (jnet, _, _), (pnet, _, _) = [_slam(*pk, **MODES[mode])
                                  for pk in PACKAGES]
    jsim = JaxSimulator(jnet, seed=0)
    model = port_build(pnet, seed=0, device="cpu")
    own = build_params(model, device="cpu")
    given = params_from_numpy(model, host_params(jsim.params), device="cpu")
    assert len(leaves(own)) == len(leaves(given)) > 0
    for a, b in zip(leaves(own), leaves(given)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the resource summary is the JAX package's, row for row
    assert pprof.model_utilization_summary(model) == \
        jprof.model_utilization_summary(jsim.model)


def test_build_params_bf16_bank_equals_jax(monkeypatch):
    """In the default bf16 the bank stays bf16 in the port's tree and
    equals the JAX package's bf16 bank."""
    monkeypatch.setenv("SSPSLAM_HOIST_CLEANUP", "1")
    monkeypatch.setenv("SSPSLAM_HOIST_GATE", "1")
    monkeypatch.delenv("SSPSLAM_CLEANUP_F32", raising=False)
    (jnet, _, _), (pnet, _, _) = [_slam(*pk) for pk in PACKAGES]
    jsim = JaxSimulator(jnet, seed=0)
    model = port_build(pnet, seed=0, device="cpu")
    own = build_params(model, device="cpu")["hoisted"]
    key = next(k for k, h in own.items() if "bank_sim" in h)
    assert own[key]["bank_sim"].dtype == torch.bfloat16
    assert jsim.params["hoisted"][key]["bank_sim"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        own[key]["bank_sim"].float().numpy(),
        np.asarray(jsim.params["hoisted"][key]["bank_sim"], np.float32))
    given = params_from_numpy(model, host_params(jsim.params), device="cpu")
    assert torch.equal(given["hoisted"][key]["bank_sim"],
                       own[key]["bank_sim"])


@pytest.mark.parametrize("mode", ["reference", "auto-anchor"])
def test_slam_runs_match_jax(mode, hoisted_f32):
    """SLAMNetwork (LIF) through both executors on the JAX weights, 300
    steps: the PI output, the gate output and the recall within the
    spike-flip bounds."""
    (jnet, jp, _), (pnet, pp, _) = [_slam(*pk, **MODES[mode])
                                    for pk in PACKAGES]
    jout, pout, *_ = assert_runs_match(jnet, pnet, STEPS, seed=0,
                                       spiking=True)
    assert len(jout) == 3
    assert np.abs(pout[0][-1]).max() > 0.05


# ---------------------------------------------------------------------------
# (6) the CLI
# ---------------------------------------------------------------------------

CLI_ARGS = ["--T", "0.3", "--limit", "2", "--ssp-dim", "25",
            "--pi-n-neurons", "80", "--mem-n-neurons", "90",
            "--circonv-n-neurons", "30", "--n-landmarks", "5", "--save"]


def _clis(cmds, out_dirs):
    """Run the CLIs side by side, one thread each (the port's small CPU
    ops only contend for more); returns (stdout, npz) of each."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               SSPSLAM_CLEANUP_F32="1", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + CLI_ARGS + ["--save-dir", str(out)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, out in zip(cmds, out_dirs)]
    results = []
    for proc, out in zip(procs, out_dirs):
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        (path,) = glob.glob(str(out / "*.npz"))
        results.append((stdout, np.load(path, allow_pickle=True)))
    return results


def test_run_slam_cli_matches_jax(tmp_path):
    """The port's CLI and the JAX CLI on the CPU save the same world and a
    trace within the spike-flip bounds, and print the same lines.
    (``--limit 2``: see test_torch_models.test_run_pathint_cli_matches_jax.)"""
    from torch_parity import assert_close
    (pout, port), (jout, ref) = _clis(
        [[sys.executable, "-m", "sspslam_tpu_torch.experiments.run_slam",
          "--device", "cpu"],
         [sys.executable, str(REPO / "experiments" / "run_slam.py"),
          "--backend", "cpu"]],
        [tmp_path / "port", tmp_path / "jax"])
    assert sorted(port.files) == sorted(ref.files)
    np.testing.assert_array_equal(port["path"], ref["path"])
    np.testing.assert_array_equal(port["obj_locs"], ref["obj_locs"])
    assert port["slam_sim_out"].shape == ref["slam_sim_out"].shape \
        == (300, 25)
    assert_close(port["slam_sim_out"], ref["slam_sim_out"], spiking=True,
                 what="slam_sim_out")
    for prefix in ("model resources:", "compile:", "sim wall time:",
                   "final distance error:",
                   "learned-map median landmark error:", "saved "):
        for out in (pout, jout):
            assert any(l.startswith(prefix) for l in out.splitlines()), \
                prefix


def test_run_slam_plot_writes_figure(tmp_path, monkeypatch):
    """``run_slam --plot`` on the CPU writes the JAX CLI's figure,
    ``figures/slam_<backend>.png`` under the working directory."""
    from torch_parity import run_port_cli
    monkeypatch.chdir(tmp_path)
    _, out = run_port_cli("run_slam", ["--backend", "cpu", "--plot",
                                       *CLI_ARGS, "--save-dir", "data"])
    png = tmp_path / "figures" / "slam_cpu.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out.splitlines()[-1] == "saved figures/slam_cpu.png"
    assert len(glob.glob(str(tmp_path / "data" / "*.npz"))) == 1


# ---------------------------------------------------------------------------
# (7) uploads and hoisted tables
# ---------------------------------------------------------------------------

def test_dft_tables_upload_once_per_device(monkeypatch):
    """After the first call for a (d, device, dtype), binding, unbinding
    and inverting upload nothing: the same tensors come back."""
    a, b = torch.randn(2, 29)
    pvsa.bind(a, b), pvsa.invert(a)
    first = pvsa._rdft_mats(29, "cpu")
    assert all(x is y for x, y in zip(first, pvsa._rdft_mats(29, a.device)))
    assert pvsa._invert_index(29, a.device) is pvsa._invert_index(29, a.device)
    calls = []
    real = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor",
                        lambda *x, **k: calls.append(1) or real(*x, **k))
    pvsa.bind(a, b), pvsa.unbind(a, b), pvsa.invert(a), \
        pvsa.make_unitary(a)
    assert not calls


def test_hoisted_shift_rate_changed_in_place_changes_the_next_step():
    """The gate's shift_rate is a tensor in ``sim.params``: zeroing it in
    place zeroes the next step's correction (update_thres -10 makes every
    in-view step correct)."""
    net, probes, _ = _slam(psp, pmodels, pnef, update_thres=-10.0)
    sim = pnef.Simulator(net, seed=0, device="cpu")
    sim.run_steps(20)
    from sspslam_tpu_torch.nef.simulator import _flatten
    saved = [x.clone() for x in _flatten(sim.state)]
    key = next(k for k, h in sim.params["hoisted"].items()
               if "shift_rate" in h)
    outs = []
    for rate in (None, 0.0):
        for x, s in zip(_flatten(sim.state), saved):
            x.copy_(s)
        if rate is not None:
            sim.params["hoisted"][key]["shift_rate"].fill_(rate)
        sim.run_steps(1)
        outs.append(sim.data[probes["gate"]][-1])
    assert np.abs(outs[0]).max() > 1e-4
    np.testing.assert_array_equal(outs[1], 0.0)
