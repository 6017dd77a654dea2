"""The port's NumPy interpreter (sspslam_tpu_torch/nef/reference_backend.py)
and the NumPy mirrors of its node functions.

- The port's ``NumpyStepper`` against the JAX package's on the same
  networks, each built by its own package (LIF, QuantizedLIF, LoihiLIF,
  LIFRate, SpikingRectifiedLinear, an Alpha synapse, PES, Voja, solver
  weights, a stateful latch with its mirror): rate networks within 1e-4,
  spiking ones within the spike-flip bounds (tests/torch_parity.py).
- The port's ``NumpyStepper`` against the port's ``Simulator`` on the CPU,
  with tests/test_backends.py's cross-check (the bulk of the steps at
  float32 tightness, the excursions rare and brief), on the small SLAM of
  tests/test_backends.py in both gate modes (SSPSLAM_CLEANUP_F32=1).
- The mirrors (ROADMAP.md Queue 3, repair 1): registered on every SLAM
  and Reencode node function, taking the hoisted consts, the
  auto-recovery gate's step by step against its torch function.
- Device-resident and bf16 leaves of a built model (repair 2).
- ``run_slam --backend numpy`` and ``run_pathint --backend numpy`` against
  the JAX CLIs (children) at a tiny width; the port's in this process.
"""

import contextlib
import glob
import importlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import sspslam_tpu.nef as jnef
from sspslam_tpu.models import AssociativeMemory as JaxAM
from sspslam_tpu.nef.reference_backend import NumpyStepper as JaxStepper
from sspslam_tpu.ops.neurons import QuantizedLIF as JaxQuantizedLIF

import sspslam_tpu_torch as psp
import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.models import AssociativeMemory as PortAM
from sspslam_tpu_torch.models import slam as pslam
from sspslam_tpu_torch.models.pathintegration import PathIntegrationReencode
from sspslam_tpu_torch.nef import save_bundle, ServingModel, Simulator
from sspslam_tpu_torch.nef.reference_backend import NumpyStepper
from sspslam_tpu_torch.ops.neurons import QuantizedLIF as PortQuantizedLIF

from torch_parity import assert_close, leaves

REPO = Path(__file__).resolve().parents[1]
BOUNDS = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (1) the port's interpreter against the JAX package's
# ---------------------------------------------------------------------------

def _latch(pkg):
    """A running-max latch node function (stateful) with its mirror."""
    mx = jnp.maximum if pkg is jnef else torch.maximum

    def latch(t, x, s, consts=None):
        ns = mx(s, x)
        return ns, ns
    latch.state_init = np.zeros(2, np.float32)

    def latch_np(t, x, s, consts=None):
        ns = np.maximum(s, x)
        return ns, ns
    latch.np_function = latch_np
    return latch


def _network(pkg, name):
    """(network, spiking) of case ``name`` built with ``pkg``'s nef."""
    nef = pkg
    qlif = JaxQuantizedLIF if pkg is jnef else PortQuantizedLIF
    am_cls = JaxAM if pkg is jnef else PortAM
    neuron = {"LIF": nef.LIF, "QuantizedLIF": qlif, "LoihiLIF": nef.LoihiLIF,
              "LIFRate": nef.LIFRate,
              "SpikingRectifiedLinear": nef.SpikingRectifiedLinear}
    with nef.Network(seed=0) as net:
        if name in neuron:
            inp = nef.Node(lambda t: np.array([np.sin(8 * t), 0.3]))
            ens = nef.Ensemble(90, 2, neuron_type=neuron[name](), seed=0)
            nef.Connection(inp, ens, synapse=None)
            nef.Probe(ens, synapse=0.02)
        elif name == "alpha":
            inp = nef.Node(lambda t: np.array([np.sin(8 * t)]))
            ens = nef.Ensemble(60, 1, neuron_type=nef.LIFRate(), seed=0)
            out = nef.Node(size_in=1)
            nef.Connection(inp, ens, synapse=nef.Alpha(0.01))
            nef.Connection(ens, out, synapse=nef.Alpha(0.02))
            nef.Probe(out, synapse=None)
        elif name == "pes":
            val = np.array([0.5, -0.2])
            inp = nef.Node(lambda t: val)
            ens = nef.Ensemble(100, 2, neuron_type=nef.LIFRate(), seed=0)
            out = nef.Node(size_in=2)
            nef.Connection(inp, ens, synapse=None)
            c = nef.Connection(ens, out, function=lambda x: np.zeros(2),
                               learning_rule_type=nef.PES(1e-3),
                               synapse=0.02)
            err = nef.Node(lambda t, x: x, size_in=2)   # no mirror
            nef.Connection(out, err, synapse=0.02)
            nef.Connection(inp, err, transform=-1.0, synapse=0.02)
            nef.Connection(err, c.learning_rule, synapse=0.02)
            nef.Probe(out, synapse=0.02)
        elif name == "voja":
            rng = np.random.default_rng(3)
            keys = rng.standard_normal((2, 4))
            keys /= np.linalg.norm(keys, axis=1, keepdims=True)
            vals = rng.standard_normal((2, 3)) * 0.5
            key_in = nef.Node(lambda t: keys[int(t > 0.1)])
            val_in = nef.Node(lambda t: vals[int(t > 0.1)])
            learn = nef.Node(lambda t: np.zeros(1))
            am = am_cls(80, 4, 3, intercept=0.1, neuron_type=nef.LIFRate(),
                        seed=2)
            nef.Connection(key_in, am.key_input, synapse=None)
            nef.Connection(val_in, am.value_input, synapse=None)
            nef.Connection(learn, am.learning, synapse=None)
            nef.Probe(am.recall, synapse=0.02)
        elif name == "solver_weights":
            inp = nef.Node(lambda t: np.array([0.5, 0.1]))
            a = nef.Ensemble(70, 2, neuron_type=nef.LIFRate(), seed=5)
            b = nef.Ensemble(70, 2, neuron_type=nef.LIFRate(), seed=6)
            nef.Connection(inp, a, synapse=None)
            nef.Connection(a, b, synapse=0.01, solver_weights=True)
            nef.Probe(b, synapse=0.02)
        else:   # latch
            inp = nef.Node(lambda t: np.array([np.sin(7 * t),
                                               np.cos(5 * t)]))
            n = nef.Node(_latch(pkg), size_in=2, size_out=2)
            nef.Connection(inp, n, synapse=None)
            out = nef.Node(size_in=2)
            nef.Connection(n, out, synapse=0.02)
            nef.Probe(out, synapse=None)
    spiking = name in ("LIF", "QuantizedLIF", "LoihiLIF",
                       "SpikingRectifiedLinear")
    return net, spiking


CASES = ["LIF", "QuantizedLIF", "LoihiLIF", "LIFRate",
         "SpikingRectifiedLinear", "alpha", "pes", "voja", "solver_weights",
         "latch"]


@pytest.mark.parametrize("name", CASES)
def test_interpreter_matches_jax_interpreter(name):
    n_steps = 200
    jnet, spiking = _network(jnef, name)
    pnet, _ = _network(pnef, name)
    jsim = jnef.Simulator(jnet, seed=0)
    model = pnef.build(pnet, seed=0, device="cpu")
    tables = [np.asarray(c) for c in jsim._tabulate_inputs(n_steps)]
    want = JaxStepper(jsim.model).run_steps(n_steps, tables)
    ref = NumpyStepper(model)
    got = ref.run_steps(n_steps, tables)
    assert got.keys() == want.keys() and got
    for k in got:
        assert np.all(np.isfinite(got[k])) and np.abs(got[k]).max() > 0
        assert_close(got[k], want[k], spiking, what=f"{name} probe {k}")
    if name == "latch":
        (v,) = ref.state["nodes"].values()
        assert v.shape == (2,) and (v > 0.9).all()


# ---------------------------------------------------------------------------
# (2) the port's interpreter against the port's Simulator
# ---------------------------------------------------------------------------

def cross_check(net, n_steps, seed=0, atol=1e-3, spike_flip_tolerant=False,
                hoisted=None):
    """tests/test_backends.py's cross_check on the port: the Simulator and
    the interpreter on the same built model; ``hoisted``: a function of
    the Simulator that changes its hoisted tables first and returns them
    for the interpreter."""
    sim = Simulator(net, seed=seed, device="cpu")
    tables = [np.asarray(c) for c in sim._tabulate_inputs(n_steps)]
    ref_out = NumpyStepper(
        sim.model, hoisted=hoisted(sim) if hoisted else None).run_steps(
        n_steps, tables)
    sim.run_steps(n_steps)
    for bp in sim.model.probes:
        if bp.sparse:
            continue
        sim_v = sim.data[bp.obj]
        ref_v = ref_out[bp.index]
        per_t = np.max(np.abs(sim_v - ref_v),
                       axis=tuple(range(1, sim_v.ndim)))
        scale = max(np.max(np.abs(ref_v)), 1.0)
        if not spike_flip_tolerant:
            assert per_t.max() / scale < atol, (bp.index, per_t.max())
            continue
        exc = per_t / scale > 5 * atol
        run, longest = 0, 0
        for e in exc:
            run = run + 1 if e else 0
            longest = max(longest, run)
        assert np.median(per_t) / scale < atol, bp.index
        assert np.quantile(per_t, 0.80) / scale < 5 * atol, bp.index
        assert per_t.max() / scale < 0.25, bp.index
        assert np.mean(exc) < 0.10, bp.index
        assert longest <= max(5, int(0.03 * len(exc))), bp.index
    return sim


def _slam_net(gate_mode):
    """tests/test_backends.py's small SLAM: ssp_dim 31, 60 per VCO, a
    moving 0.15 s path, two landmarks."""
    T, dt, seed = 0.15, 0.001, 0
    space = psp.HexagonalSSPSpace(2, ssp_dim=31, seed=seed,
                                  length_scale=0.3, domain_bounds=BOUNDS)
    d = space.ssp_dim
    ts = dt * np.arange(int(T / dt))
    path = 0.25 * np.stack([np.sin(2 * np.pi * ts / T),
                            np.cos(2 * np.pi * ts / T) - 1.0], axis=1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = np.random.default_rng(seed).uniform(-0.3, 0.3, size=(2, 2))
    vec_to_lm = landmarks[None, :, :] - path[:, None, :]
    lm_space = psp.SPSpace(2, d, seed=seed)
    (velocity_func, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        pslam.get_slam_input_functions(space, lm_space, vels, vec_to_lm, 2.0)
    kw = ({"gate_kwargs": {"familiar": 0.05, "exit_thres": 0.3}}
          if gate_mode == "auto_recovery" else {})
    with pnef.Network(seed=seed) as net:
        vel = pnef.Node(velocity_func)
        lm_id = pnef.Node(sp_f)
        lm_ssp = pnef.Node(vecssp_f)
        in_view = pnef.Node(in_view_f)
        slam = pslam.SLAMNetwork(space, lm_space, 2.0, 2, pi_n_neurons=60,
                                 mem_n_neurons=80, circonv_n_neurons=30,
                                 vel_scaling_factor=scale,
                                 cleanup_samples_per_dim=10, seed=seed,
                                 gate_mode=gate_mode, **kw)
        pnef.Connection(vel, slam.velocity_input, synapse=None)
        pnef.Connection(lm_id, slam.landmark_id_input, synapse=None)
        pnef.Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        pnef.Connection(in_view, slam.no_landmark_in_view, synapse=None)
        pnef.Probe(slam.pathintegrator.output, synapse=0.02)
        pnef.Probe(slam.assomemory.recall, synapse=0.02)
        pnef.Probe(slam.update_state, synapse=None)
    return net


@pytest.mark.parametrize("gate_mode", ["reference", "auto_recovery"])
def test_slam_interpreter_matches_simulator(monkeypatch, gate_mode):
    """The full SLAMNetwork (clean-up, gate, Voja / PES memory, circular
    convolutions): the interpreter, which prefers the mirrors, against the
    Simulator's step; with the auto-recovery gate its node state too."""
    monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
    sim = cross_check(_slam_net(gate_mode), 150, spike_flip_tolerant=True)
    if gate_mode == "auto_recovery":
        (slot,) = sim.state["nodes"]
        armed, ema, timer, cons_ema = sim.state["nodes"][slot].numpy()
        assert timer >= 0 and np.isfinite(ema) and -1.01 <= cons_ema <= 1.01


# ---------------------------------------------------------------------------
# (3) the mirrors
# ---------------------------------------------------------------------------

def test_np_mirrors_registered():
    """Every node function of the SLAM model (both gates, the clean-up)
    and PathIntegrationReencode's timed clean-up carries a NumPy mirror."""
    space = psp.HexagonalSSPSpace(2, ssp_dim=31, seed=0, length_scale=0.3,
                                  domain_bounds=BOUNDS)
    lm_space = psp.SPSpace(2, space.ssp_dim, seed=0)
    for gate_mode in ("reference", "auto_recovery"):
        with pnef.Network(seed=0) as net:
            pslam.SLAMNetwork(space, lm_space, 0.6, 2, pi_n_neurons=50,
                              mem_n_neurons=60, circonv_n_neurons=20,
                              cleanup_samples_per_dim=10, seed=0,
                              gate_mode=gate_mode)
        model = pnef.build(net, seed=0, device="cpu")
        nodes = [info for info in model.node_info.values()
                 if info["kind"] == "jnp_func"]
        assert len(nodes) == 2
        assert all(info.get("np_func") is not None for info in nodes)
    with pnef.Network(seed=0) as net:
        PathIntegrationReencode(space, 40, cleanup_samples_per_dim=10)
    model = pnef.build(net, seed=0, device="cpu")
    (info,) = [i for i in model.node_info.values() if i["kind"] == "jnp_func"]
    assert info["np_func"] is not None and info["hoisted_key"] is not None


def test_gate_np_mirror_honors_hoisted_consts():
    """The reference gate's mirror applies the SAME consts as the torch
    gate: swept consts that open it, and the built (closed) ones."""
    d = 3
    f = pslam.make_update_state_func(0.9, 0.1, d)   # built: gate CLOSED
    v = np.full(d, 0.5, np.float32)
    x = np.concatenate([v, 0.9 * v, [0.0]]).astype(np.float32)
    # dot = 0.675: swept consts OPEN the gate with a new rate
    consts = {"update_thres": np.float32(0.5), "shift_rate": np.float32(0.7)}
    got = f.np_function(0.0, x, consts=consts)
    want = f(0.0, torch.as_tensor(x),
             consts={k: torch.as_tensor(c) for k, c in consts.items()})
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)
    for c in (None, f.hoisted_consts):
        assert np.all(f.np_function(0.0, x, consts=c) == 0)
    assert torch.all(f(0.0, torch.as_tensor(x)) == 0)


@pytest.mark.parametrize("anchor", [False, True])
def test_auto_recovery_gate_mirror_steps_like_the_gate(anchor):
    """The auto-recovery gate's mirror against its torch function over 400
    steps of random inputs: outputs and states, the arming latch, a
    recovery window and (with anchors) the absolute channel exercised."""
    d, steps = 13, 400
    gate = pslam.make_auto_recovery_gate_func(
        0.2, 0.1, d, recovery_T=0.05, familiar=0.3, exit_thres=0.2,
        trigger=0.3, anchor=anchor)
    consts_np = gate.hoisted_consts
    consts_t = {k: torch.as_tensor(v) for k, v in consts_np.items()}
    rng = np.random.default_rng(1)
    s_np = gate.state_init.copy()
    s_t = torch.as_tensor(gate.state_init)
    base = rng.normal(size=d).astype(np.float32)
    in_rec = 0
    for i in range(steps):
        pos = base + 0.3 * rng.normal(size=d)
        pi = base * (1.0 if i < 200 else -1.0) + 0.3 * rng.normal(size=d)
        parts = [pos, pi, rng.normal(size=d), 0.3 * rng.normal(size=d)]
        if anchor:
            parts += [rng.normal(size=d), rng.normal(size=d),
                      [0.0 if i % 3 else 5.0]]
        parts.append([0.0 if i % 4 else 5.0])
        x = np.concatenate(parts).astype(np.float32)
        out_np, s_np = gate.np_function(0.0, x, s_np, consts_np)
        out_t, s_t = gate(0.0, torch.as_tensor(x), s_t, consts_t)
        np.testing.assert_allclose(out_np, out_t.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(s_np, s_t.numpy(), rtol=1e-4, atol=1e-5)
        in_rec += out_np[d] > 0
    assert s_np[0] == 1.0 and 0 < in_rec < steps


def test_hoisted_gate_cross_check():
    """A gate whose hoisted consts are rewritten in the Simulator's params
    (a swept threshold): the interpreter given ``sim.params["hoisted"]``
    (tensors) follows it through the mirror, as the Simulator does."""
    d = 4
    f = pslam.make_update_state_func(2.0, 0.3, d)   # built: never open
    rows = np.random.default_rng(0).normal(size=(60, 2 * d + 1)).astype(
        np.float32)
    rows[::2, -1] = 0.0
    with pnef.Network(seed=0) as net:
        drive = pnef.Node(pnef.TimeTable(rows))
        gate = pnef.Node(f, size_in=2 * d + 1, size_out=d)
        pnef.Connection(drive, gate, synapse=None)
        pnef.Probe(gate, synapse=None)

    def opened(sim):
        (key,) = sim.params["hoisted"]
        sim.params["hoisted"][key]["update_thres"].fill_(-1.0)
        return sim.params["hoisted"]
    sim = cross_check(net, 60, atol=1e-5, hoisted=opened)
    assert np.abs(sim.data[sim.model.probes[0].obj]).max() > 0


# ---------------------------------------------------------------------------
# (4) device-resident and bf16 leaves of a built model
# ---------------------------------------------------------------------------

def test_tensor_leaves_of_a_built_model(tmp_path):
    """A build whose hoisted clean-up bank is a bf16 tensor (the default
    similarity dtype), with a learned initial weight and a static decoder
    given as tensors (as a solve on the card leaves them): the interpreter
    reads them as the arrays they hold, and save_bundle writes the bf16
    bank's bits."""
    net = _slam_net("reference")
    sim = Simulator(net, seed=0, device="cpu")
    model = sim.model
    banks = [t for h in model.hoisted.values() for t in h.values()
             if torch.is_tensor(t) and t.dtype == torch.bfloat16]
    assert banks
    tables = [np.asarray(c) for c in sim._tabulate_inputs(40)]
    want = NumpyStepper(model).run_steps(40, tables)
    slot = next(iter(model.learned_init))
    model.learned_init[slot] = torch.as_tensor(model.learned_init[slot])
    bc = next(bc for bc in model.connections
              if bc.decoders is not None and bc.learned_slot is None)
    bc.decoders = torch.as_tensor(bc.decoders)
    got = NumpyStepper(model).run_steps(40, tables)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    save_bundle(sim, str(tmp_path / "b"), segment_steps=20)
    m = ServingModel(str(tmp_path / "b"), device="cpu")
    key = next(k for k, h in model.hoisted.items() if "bank_sim" in h)
    # every leaf with the live params' strides (the bank is
    # Fortran-ordered): the card picks its kernels by layout
    assert [t.stride() for t in m._params] == [
        t.stride() for t in leaves(sim.params)]
    assert any(not t.is_contiguous() for t in m._params)
    served = m.params["hoisted"][key]["bank_sim"]
    assert served.dtype == torch.bfloat16
    assert torch.equal(served, sim.params["hoisted"][key]["bank_sim"])
    rows = sim._pack_cols(sim._tabulate_inputs(40))
    sim.run_steps(40, segment_steps=20)
    probe = model.probes[0]
    np.testing.assert_array_equal(m.run(rows)[m.meta["probes"][0]["label"]],
                                  sim.data[probe.obj])


# ---------------------------------------------------------------------------
# (5) the CLIs' --backend numpy
# ---------------------------------------------------------------------------

SLAM_ARGS = ["--T", "0.3", "--limit", "2", "--ssp-dim", "25",
             "--pi-n-neurons", "80", "--mem-n-neurons", "90",
             "--circonv-n-neurons", "30", "--n-landmarks", "5"]
# T * limit >= 1, so the path moves (ROADMAP.md Queue 3: a shorter
# band-limited path is constant)
PI_ARGS = ["--T", "0.5", "--limit", "2", "--ssp-dim", "31",
           "--pi-n-neurons", "100", "--neuron-type", "lifrate", "--save"]


def _printed(out, prefix):
    line = next(l for l in out.splitlines() if l.startswith(prefix))
    return [float(x) for x in line.replace(";", "").split()[3::2]]


def test_numpy_backend_clis_match_jax(tmp_path, monkeypatch):
    """``run_slam --backend numpy`` and ``run_pathint --backend numpy`` on
    the CPU against the JAX CLIs: the same printed errors (SLAM; the JAX
    CLI's --save fails on this backend, as its map extraction reads the
    Simulator, which did not run) and the same saved PI trace within 1e-4
    (LIFRate); the port's SLAM also saves its learned map, read from the
    interpreter's final state."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               SSPSLAM_CLEANUP_F32="1", OMP_NUM_THREADS="1")
    jax_runs = {
        "run_slam": ["run_slam.py", "--backend", "numpy", *SLAM_ARGS],
        "run_pathint": ["run_pathint.py", "--backend", "numpy", *PI_ARGS,
                        "--save-dir", str(tmp_path / "jax")]}
    procs = {name: subprocess.Popen(
        [sys.executable, str(REPO / "experiments" / script), *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, (script, *args) in jax_runs.items()}
    port_runs = {
        "run_slam": ["--backend", "numpy", "--device", "cpu", *SLAM_ARGS,
                     "--save", "--save-dir", str(tmp_path / "slam")],
        "run_pathint": ["--backend", "numpy", "--device", "cpu", *PI_ARGS,
                        "--save-dir", str(tmp_path / "port")]}
    pout = {}
    monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
    for name, args in port_runs.items():
        cli = importlib.import_module(f"sspslam_tpu_torch.experiments.{name}")
        # one BLAS thread, as the children: the recurrent PI amplifies a
        # summation order's last bit to 1e-3 within 300 steps
        with contextlib.redirect_stdout(io.StringIO()) as out, \
                threadpool_limits(1):
            cli.main(args)
        pout[name] = out.getvalue()
    jout = {}
    for name, proc in procs.items():
        jout[name], stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])

    for name in procs:
        for prefix in ("sim wall time:", "final distance error:"):
            for out in (pout[name], jout[name]):
                assert any(l.startswith(prefix)
                           for l in out.splitlines()), (name, prefix)
        assert not any(l.startswith("compile:")
                       for l in pout[name].splitlines())
        errs = _printed(pout[name], "final distance error:")
        assert errs == _printed(jout[name], "final distance error:"), name
        assert all(np.isfinite(errs))
    (path,) = glob.glob(str(tmp_path / "slam" / "*_backend_numpy_*.npz"))
    assert np.isfinite(np.load(path, allow_pickle=True)["landmark_loc_est"]
                       ).all()
    assert "learned-map median landmark error:" in pout["run_slam"]
    (port,) = glob.glob(str(tmp_path / "port" / "*_backend_numpy_*.npz"))
    (ref,) = glob.glob(str(tmp_path / "jax" / "*_backend_numpy_*.npz"))
    port, ref = np.load(port, allow_pickle=True), np.load(ref, allow_pickle=True)
    assert sorted(port.files) == sorted(ref.files)
    assert port["pi_sim_out"].shape == (500, 25)
    assert np.abs(np.diff(port["path"], axis=0)).max() > 0
    assert_close(port["pi_sim_out"], ref["pi_sim_out"], what="pi_sim_out")
    np.testing.assert_allclose(port["pi_error"], ref["pi_error"], atol=1e-6)
