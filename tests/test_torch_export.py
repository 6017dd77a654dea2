"""The port's serving bundle (sspslam_tpu_torch/nef/export.py) against the
contract of tests/test_export.py: bit for bit equal to the live port
Simulator, chained calls, learned PES state shipping with the state,
checkpoint swap-in (port and JAX checkpoint files), subsampled thinning,
mid-run export, the empty table, duplicate labels, meta.json; a load in a
fresh process that never builds a model; bf16 and int8 bundles; the three
refusals; and the port's bundle against the JAX package's bundle of the
same parameters (LIFRate within 1e-5, LIF within the spike-flip bounds of
tests/torch_parity.py)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sspslam_tpu.nef import Simulator as JaxSimulator
from sspslam_tpu.nef import ServingModel as JaxServingModel
from sspslam_tpu.nef import save_bundle as jax_save_bundle
import sspslam_tpu.nef as jnef

import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.nef import ServingModel, Simulator, save_bundle
from sspslam_tpu_torch.nef.executor import params_from_numpy

from torch_parity import assert_close, bits, host_params, leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(n, dt=0.001):
    ts = dt * np.arange(1, n + 1)
    return np.sin(2 * np.pi * 3.0 * ts).astype(np.float32)[:, None]


def _net(nef, n_steps, learned=False, seed=0, neuron=None, n_neurons=40,
         sample_every=None):
    neuron = neuron or nef.LIFRate
    with nef.Network(seed=seed) as net:
        inp = nef.Node(nef.TimeTable(_table(n_steps)), label="drive")
        a = nef.Ensemble(n_neurons, 1, neuron_type=neuron())
        nef.Connection(inp, a, synapse=None)
        extras = {}
        if learned:
            b = nef.Ensemble(40, 1, neuron_type=neuron())
            c = nef.Connection(a, b, function=lambda x: x * 0,
                               learning_rule_type=nef.PES(1e-2))
            err = nef.Node(lambda t, x: x, size_in=1)
            nef.Connection(b, err, synapse=0.005)
            nef.Connection(inp, err, transform=-1, synapse=0.005)
            nef.Connection(err, c.learning_rule, synapse=None)
            extras["pb"] = nef.Probe(b, synapse=0.01, label="out_b")
        p = nef.Probe(a, synapse=0.01, label="out_a",
                      sample_every=sample_every)
    return net, p, extras


def _sim(n_steps, matmul_dtype=None, **kw):
    net, p, extras = _net(pnef, n_steps, **kw)
    return Simulator(net, seed=0, device="cpu",
                     matmul_dtype=matmul_dtype), p, extras


N, SEG = 120, 40


@pytest.fixture(scope="module")
def basic(tmp_path_factory):
    """One bundle of the LIFRate network at step 0, the rows, the live
    run's trace, and port and JAX checkpoints taken after one segment."""
    d = tmp_path_factory.mktemp("basic")
    sim, p, _ = _sim(N)
    xs = sim._pack_cols(sim._tabulate_inputs(N))
    save_bundle(sim, str(d / "b"), segment_steps=SEG)
    sim.run_steps(SEG, segment_steps=SEG)
    sim.save_checkpoint(str(d / "ckpt"))
    sim.run_steps(N - SEG, segment_steps=SEG)
    jnet, _, _ = _net(jnef, N)
    jsim = JaxSimulator(jnet, seed=0)
    jsim.run_steps(SEG, segment_steps=SEG)
    jsim.save_checkpoint(str(d / "jax_ckpt"))
    return {"dir": d, "b": str(d / "b"), "xs": xs, "want": sim.data[p]}


def test_bundle_matches_live_simulator(basic):
    m = ServingModel(basic["b"], device="cpu")
    out = m.run(basic["xs"])
    np.testing.assert_array_equal(out["out_a"], basic["want"])
    assert m.n_steps == N


def test_chained_calls_continue_state(basic):
    m = ServingModel(basic["b"], device="cpu")
    xs, want = basic["xs"], basic["want"]
    got = np.concatenate([m.run(xs[:SEG])["out_a"],
                          m.run(xs[SEG:])["out_a"]])
    np.testing.assert_array_equal(got, want)
    m.reset()
    assert m.n_steps == 0
    np.testing.assert_array_equal(m.run(xs)["out_a"], want)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_checkpoint_swap_in(basic, package):
    """A checkpoint taken after one segment swaps into the bundle: the
    port's continues its own live run bit for bit; the JAX package's (the
    same file format) continues as a port Simulator that loaded it."""
    xs = basic["xs"]
    ckpt = str(basic["dir"] / ("ckpt" if package == "port" else "jax_ckpt"))
    if package == "port":
        want = basic["want"][SEG:]
    else:
        sim, p, _ = _sim(N)
        sim.load_checkpoint(ckpt)
        sim.run_steps(N - SEG, segment_steps=SEG)
        want = sim.data[p]
    m = ServingModel(basic["b"], device="cpu")
    m.load_state(ckpt)
    assert m.n_steps == SEG
    np.testing.assert_array_equal(m.run(xs[SEG:])["out_a"], want)


def test_empty_table_keeps_probe_shape(basic):
    m = ServingModel(basic["b"], device="cpu")
    out = m.run(np.zeros((0, m.input_width), np.float32))
    assert out["out_a"].shape == (0, 1)
    assert m.n_steps == 0


def test_meta_contents(basic):
    meta = json.load(open(os.path.join(basic["b"], "meta.json")))
    assert {"format_version", "dt", "segment_steps", "n_steps_at_export",
            "input_width", "inputs", "probes", "params_spec", "state_spec",
            "mesh"} <= set(meta)
    assert meta["segment_steps"] == SEG
    assert meta["dt"] == pytest.approx(0.001)
    assert meta["mesh"] is None and meta["n_steps_at_export"] == 0
    assert meta["inputs"] == [{"label": "drive", "a": 0, "b": 1}]
    assert meta["probes"] == [{"index": 0, "label": "out_a", "shape": [1],
                               "period_steps": 1}]
    assert sorted(os.listdir(basic["b"])) == ["arrays.npz", "meta.json",
                                              "step.pt2"]


def test_loads_without_model_graph(basic, tmp_path):
    """A fresh process loads the bundle and steps it with the builder
    patched to raise and no JAX imported: the deployment contract."""
    np.save(tmp_path / "xs.npy", basic["xs"])
    np.save(tmp_path / "want.npy", basic["want"])
    script = f"""
import sys
import numpy as np
import sspslam_tpu_torch.nef.builder as builder
import sspslam_tpu_torch.nef.simulator as simulator

def refuse(*a, **k):
    raise AssertionError("the serving process built a model")
builder.build = simulator.build = refuse
from sspslam_tpu_torch.nef import ServingModel
m = ServingModel({basic['b']!r}, device="cpu")
out = m.run(np.load({str(tmp_path / 'xs.npy')!r}))["out_a"]
np.testing.assert_array_equal(out, np.load({str(tmp_path / 'want.npy')!r}))
assert not [k for k in sys.modules if k == "jax" or k.startswith(
    ("jax.", "sspslam_tpu.", "ml_dtypes"))] and "sspslam_tpu" not in sys.modules
print("SERVED_OK", out.shape)
"""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SERVED_OK" in r.stdout


@pytest.mark.parametrize("matmul_dtype", ["bf16", "int8"])
def test_quantised_bundle_matches_live(tmp_path, matmul_dtype):
    """bf16 leaves travel as their raw bits and int8 leaves as QTensor
    nodes; the bundle still equals the live run bit for bit."""
    sim, p, _ = _sim(N, matmul_dtype=matmul_dtype)
    xs = sim._pack_cols(sim._tabulate_inputs(N))
    save_bundle(sim, str(tmp_path / "b"), segment_steps=SEG)
    meta = json.load(open(tmp_path / "b" / "meta.json"))
    text = json.dumps(meta["params_spec"])
    assert '"dtype": "bfloat16"' in text
    assert ('"t": "qtensor"' in text) == (matmul_dtype == "int8")
    sim.run_steps(N, segment_steps=SEG)
    m = ServingModel(str(tmp_path / "b"), device="cpu")
    assert len(m._params) == len(leaves(sim.params))
    for got, want in zip(m._params, leaves(sim.params)):
        assert got.dtype == want.dtype and torch.equal(bits(got), bits(want))
    np.testing.assert_array_equal(m.run(xs)["out_a"], sim.data[p])


def test_learned_state_ships_with_carry(tmp_path):
    """Exporting AFTER a training run bakes the learned PES decoders into
    the bundle's initial state."""
    n, seg = 200, 50
    sim, p, extras = _sim(2 * n, learned=True)
    xs_all = sim._pack_cols(sim._tabulate_inputs(2 * n))
    sim.run_steps(n, segment_steps=seg)
    save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
    sim.run_steps(n, segment_steps=seg)
    want = sim.data[extras["pb"]][n:]
    m = ServingModel(str(tmp_path / "b"), device="cpu")
    np.testing.assert_array_equal(m.run(xs_all[n:])["out_b"], want)


def test_subsampled_thinning_and_midrun_export(tmp_path):
    """Thinned probe rows equal the live run's, from step 0 and from a
    bundle saved mid-period (step 15): the phase comes from the exported
    step counter, and a checkpoint restores the counter too."""
    n, seg = 150, 30
    sim, p, _ = _sim(n, n_neurons=30, sample_every=0.01)
    xs = sim._pack_cols(sim._tabulate_inputs(n))
    save_bundle(sim, str(tmp_path / "b0"), segment_steps=seg)
    sim.run_steps(15, segment_steps=15)
    save_bundle(sim, str(tmp_path / "b15"), segment_steps=seg)
    sim.run_steps(120, segment_steps=seg)
    want = sim.data[p]          # rows at steps 10, 20, 30, ...

    m = ServingModel(str(tmp_path / "b0"), device="cpu")
    got = m.run(xs[:120])["out_a"]
    np.testing.assert_array_equal(got, want[:got.shape[0]])
    assert got.shape == (12, 1)

    m = ServingModel(str(tmp_path / "b15"), device="cpu")
    assert m.n_steps == 15
    got = m.run(xs[15:15 + 120])["out_a"]    # 4 whole segments
    np.testing.assert_array_equal(got, want[1:1 + got.shape[0]])
    sim.save_checkpoint(str(tmp_path / "ckpt"))
    m.load_state(str(tmp_path / "ckpt"))
    assert m.n_steps == sim.n_steps


def test_duplicate_labels_stay_distinct(tmp_path):
    n, seg = 40, 20
    with pnef.Network(seed=0) as net:
        inp = pnef.Node(pnef.TimeTable(_table(n)), label="drive")
        a = pnef.Ensemble(20, 1, neuron_type=pnef.LIFRate())
        b = pnef.Ensemble(20, 1, neuron_type=pnef.LIFRate())
        pnef.Connection(inp, a, synapse=None)
        pnef.Connection(inp, b, transform=-1, synapse=None)
        pa = pnef.Probe(a, synapse=0.01, label="out")
        pb = pnef.Probe(b, synapse=0.01, label="out")
    sim = Simulator(net, seed=0, device="cpu")
    xs = sim._pack_cols(sim._tabulate_inputs(n))
    save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
    sim.run_steps(n, segment_steps=seg)
    out = ServingModel(str(tmp_path / "b"), device="cpu").run(xs)
    assert set(out) == {"out", "out_2"}
    np.testing.assert_array_equal(out["out"], sim.data[pa])
    np.testing.assert_array_equal(out["out_2"], sim.data[pb])


def test_export_leaves_first_use_tables_real(tmp_path):
    """A node function whose DFT tables are made at first use (vsa.bind),
    exported before any step ran: the tables are cached as tensors (not
    the tracer's stand-ins), so the live run after the export and the
    bundle both bind correctly."""
    from sspslam_tpu_torch.ops import vsa
    d = 23
    rows = np.random.default_rng(0).normal(size=(40, 2 * d)).astype(
        np.float32)
    with pnef.Network(seed=0) as net:
        drive = pnef.Node(pnef.TimeTable(rows))
        bound = pnef.Node(lambda t, x: vsa.bind(x[:d], x[d:]),
                          size_in=2 * d, size_out=d)
        pnef.Connection(drive, bound, synapse=None)
        p = pnef.Probe(bound, synapse=None, label="bound")
    sim = Simulator(net, seed=0, device="cpu")
    vsa._rdft_mats_on.cache_clear()
    save_bundle(sim, str(tmp_path / "b"), segment_steps=20)
    sim.run_steps(40, segment_steps=20)
    want = np.fft.ifft(np.fft.fft(rows[:, :d]) * np.fft.fft(rows[:, d:])).real
    np.testing.assert_allclose(sim.data[p], want, atol=1e-5)
    got = ServingModel(str(tmp_path / "b"), device="cpu").run(rows)["bound"]
    np.testing.assert_array_equal(got, sim.data[p])


# ---------------------------------------------------------------------------
# the refusals and the JAX package's bundle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The same LIFRate and LIF networks exported by both packages, the
    port's Simulator given the JAX package's params (params_from_numpy);
    the rows both are fed."""
    d = tmp_path_factory.mktemp("parity")
    out = {}
    for name, n_steps, n_neurons in (("LIFRate", 120, 40), ("LIF", 300, 100)):
        jnet, _, _ = _net(jnef, n_steps, neuron=getattr(jnef, name),
                          n_neurons=n_neurons)
        pnet, _, _ = _net(pnef, n_steps, neuron=getattr(pnef, name),
                          n_neurons=n_neurons)
        jsim = JaxSimulator(jnet, seed=0)
        psim = Simulator(pnet, seed=0, device="cpu")
        psim.params = params_from_numpy(psim.model, host_params(jsim.params),
                                        device="cpu")
        xs = np.asarray(jsim._pack_cols(jsim._tabulate_inputs(n_steps)),
                        np.float32)
        jax_save_bundle(jsim, str(d / f"jax_{name}"), segment_steps=SEG)
        save_bundle(psim, str(d / f"port_{name}"), segment_steps=SEG)
        out[name] = (str(d / f"jax_{name}"), str(d / f"port_{name}"), xs)
    return out


@pytest.mark.parametrize("neuron", ["LIFRate", "LIF"])
def test_port_bundle_matches_jax_bundle(parity, neuron):
    jdir, pdir, xs = parity[neuron]
    want = JaxServingModel(jdir).run(xs)["out_a"]
    got = ServingModel(pdir, device="cpu").run(xs)["out_a"]
    assert got.shape == want.shape and np.all(np.isfinite(got))
    if neuron == "LIFRate":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.abs(want).max() > 0.1
        assert_close(got, want, spiking=True, what="LIF bundle")


@pytest.mark.parametrize("refusal", ["platforms", "mesh", "jax_only"])
def test_not_carried_refusals(parity, basic, tmp_path, refusal):
    """Multi-platform lowering and the JAX package's StableHLO bundles are
    not carried: each raises, naming the list.  A sharded bundle served in
    a process with no process group raises, naming the mesh and how to
    start its ranks (never an unsharded run)."""
    error, match = NotImplementedError, "do not carry"
    if refusal == "mesh":
        error, match = RuntimeError, r"\[8\] mesh.*spawn.*no process group"
    with pytest.raises(error, match=match):
        if refusal == "platforms":
            sim, _, _ = _sim(N)
            save_bundle(sim, str(tmp_path / "b"), segment_steps=SEG,
                        platforms=["cpu", "cuda"])
        elif refusal == "mesh":
            shutil.copytree(basic["b"], tmp_path / "b")
            meta = json.load(open(tmp_path / "b" / "meta.json"))
            meta["mesh"] = {"axis_names": ["model"], "shape": [8]}
            json.dump(meta, open(tmp_path / "b" / "meta.json", "w"))
            ServingModel(str(tmp_path / "b"), device="cpu")
        else:
            ServingModel(parity["LIFRate"][0], device="cpu")
