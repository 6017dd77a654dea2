"""The port's training path (``sspslam_tpu_torch.train``, ``SurrogateLIF``
and the train_pathint / train_slam / tune_loop_closure CLIs) against the
JAX package's, on the CPU.

Each test builds the same network with both packages from one seed, gives
the port the JAX parameters (``params_from_numpy``) and holds gradients,
loss sequences and printed numbers to the JAX package's with the tolerance
it states.  Gradients are compared relative to the largest magnitude of
the JAX gradient.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sspslam_tpu.nef as jnef
from sspslam_tpu import train as jtrain
from sspslam_tpu.ops import neurons as jneurons

import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch import train as ptrain
from sspslam_tpu_torch.ops import neurons as pneurons
from sspslam_tpu_torch.nef.executor import params_from_numpy

from torch_parity import host_params, with_port_hoisted

REPO = Path(__file__).resolve().parents[1]
# float32 gradients of the same episode through two executors
GRAD_TOL = 1e-4


def _sine_table(n_steps, dt=0.001, freq=2.0):
    ts = dt * np.arange(1, n_steps + 1)
    return np.sin(2 * np.pi * freq * ts).astype(np.float32)[:, None]


def _net(nef, neuron_type, n_steps, n_neurons):
    with nef.Network(seed=3) as net:
        inp = nef.Node(nef.TimeTable(_sine_table(n_steps)))
        ens = nef.Ensemble(n_neurons, 1, neuron_type=neuron_type)
        nef.Connection(inp, ens, synapse=None)
        p = nef.Probe(ens, synapse=0.02)
    return net, p


def _both(jnt, pnt, n_steps, n_neurons=60, default_neuron_type=None,
          net_fn=None):
    """(JAX simulator, its probe, port simulator, its probe, the port
    params carried across from JAX).  ``net_fn(nef)`` builds another
    network (returning (net, probe, extra))."""
    if net_fn is None:
        jnet, jp = _net(jnef, jnt, n_steps, n_neurons)
        pnet, pp = _net(pnef, pnt, n_steps, n_neurons)
        jx = px = None
    else:
        jnet, jp, jx = net_fn(jnef)
        pnet, pp, px = net_fn(pnef)
    jsim = jnef.Simulator(jnet, seed=3,
                          default_neuron_type=default_neuron_type[0]
                          if default_neuron_type else None)
    psim = pnef.Simulator(pnet, seed=3, device="cpu",
                          default_neuron_type=default_neuron_type[1]
                          if default_neuron_type else None)
    params = params_from_numpy(
        psim.model, with_port_hoisted(psim.model, host_params(jsim.params)),
        device="cpu")
    return jsim, jp, psim, pp, params, jx, px


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_grad(episode, params, xs, state0, path, loss_fn):
    """d loss / d (the leaf at ``path``) through the port's episode."""
    tr, fz = ptrain.partition_params(params, lambda s: s == path)
    leaf = [None]

    def req(x):
        if x is None:
            return None
        leaf[0] = x.detach().clone().requires_grad_(True)
        return leaf[0]
    tr = ptrain._tree_map(req, tr)
    final, emits = episode(ptrain.merge_params(tr, fz), xs, state0)
    g, = torch.autograd.grad(loss_fn(emits, final), leaf[0])
    return g.numpy()


def _jax_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# SurrogateLIF
# ---------------------------------------------------------------------------

def test_surrogate_step_gradients_match_jax_at_ties():
    """SurrogateLIF.step's gradients with respect to J, voltage and
    refractory time against ``jax.grad``, on a state where a quarter of
    the neurons are refractory at voltage 0 (= min_voltage: JAX's
    ``jnp.maximum`` gives half the gradient there, ``torch.clamp_min`` all
    of it) and some spike; the same for LIF.  Tolerance 1e-5 relative."""
    rng = np.random.default_rng(0)
    n = 64
    J = rng.uniform(0, 3, n).astype(np.float32)
    v = rng.uniform(0, 1.2, n).astype(np.float32)
    r = np.zeros(n, np.float32)
    v[:16] = 0.0
    r[:16] = rng.uniform(0.0021, 0.003, 16)   # refractory all this step
    w = rng.normal(size=n).astype(np.float32)
    for jcls, pcls in ((jneurons.SurrogateLIF, pneurons.SurrogateLIF),
                       (jneurons.LIF, pneurons.LIF)):
        def jloss(J, v, r):
            s, o = jcls().step({"voltage": v, "refractory": r}, J, 0.001)
            return (jnp.sum(o * 1e-3) + jnp.sum(w * s["voltage"])
                    + jnp.sum(100.0 * s["refractory"]))
        want = jax.grad(jloss, argnums=(0, 1, 2))(J, v, r)
        tJ, tv, tr = (torch.tensor(a, requires_grad=True) for a in (J, v, r))
        s, o = pcls().step({"voltage": tv, "refractory": tr}, tJ, 0.001)
        loss = ((o * 1e-3).sum() + (torch.from_numpy(w) * s["voltage"]).sum()
                + (100.0 * s["refractory"]).sum())
        got = torch.autograd.grad(loss, (tJ, tv, tr))
        spiked = (s["voltage"] == 0).numpy() & (v > 0)
        assert spiked.any()
        for g, ref, what in zip(got, want, ("J", "voltage", "refractory")):
            assert _rel(g.numpy(), ref) <= 1e-5, (jcls.__name__, what)
    # LIF: the refractory neurons' voltage gradient is the tie's half
    np.testing.assert_allclose(got[1].numpy()[:16], 0.5 * w[:16], rtol=1e-6)


def test_surrogate_gradient_shape():
    """The spike surrogate's gradient is the fast-sigmoid derivative:
    beta at the threshold, beta / (beta + 1)^2 at 1; its forward pass is
    the hard threshold."""
    x = torch.tensor([0.0, 1.0, -0.1, 0.1], requires_grad=True)
    y = pneurons._spike_surrogate(x, 10.0)
    assert y.tolist() == [0.0, 1.0, 0.0, 1.0]
    g, = torch.autograd.grad(y.sum(), x)
    want = [float(jax.grad(lambda z: jneurons._spike_surrogate(z, 10.0))(
        np.float32(a))) for a in (0.0, 1.0, -0.1, 0.1)]
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)
    assert g[0] == 10.0 and 0 < g[1] < 0.1


def test_surrogate_forward_equals_lif():
    """SurrogateLIF's forward pass is LIF's: 300 steps of the same build,
    traces within rtol 1e-5 (the multiplicative reset rounds otherwise
    than LIF's select)."""
    out = []
    for nt in (pneurons.LIF(), pneurons.SurrogateLIF(beta=5.0)):
        net, p = _net(pnef, nt, 300, 60)
        sim = pnef.Simulator(net, seed=3, device="cpu")
        sim.run_steps(300)
        out.append(sim.data[p])
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Episodes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lifrate", "surrogate"])
def test_episode_gradient_matches_jax(kind):
    """d(loss)/d(probe decoders) through an episode against ``jax.grad``:
    LIFRate over 200 steps, SurrogateLIF over 120 steps whose spike trains
    are the same in both packages (the probe traces agree to 1e-5, so no
    spike flipped).  Gradients within GRAD_TOL relative."""
    n = 200 if kind == "lifrate" else 120
    jnt, pnt = ((jnef.LIFRate(), pnef.LIFRate()) if kind == "lifrate" else
                (jnef.SurrogateLIF(), pnef.SurrogateLIF()))
    jsim, jp, psim, pp, params, _, _ = _both(jnt, pnt, n)
    pi = jtrain.probe_index(jsim, jp)
    assert ptrain.probe_index(psim, pp) == pi
    jep = jtrain.make_episode_fn(jsim, n, segment_steps=40)
    pep = ptrain.make_episode_fn(psim, n, segment_steps=40)
    xs = jtrain.episode_inputs(jsim, n)
    np.testing.assert_array_equal(ptrain.episode_inputs(psim, n), xs)
    target = _sine_table(n)

    def jloss(p):
        _, emits = jep(p, xs, jsim.model.initial_state())
        return jnp.mean((emits[pi] - target) ** 2)

    def ploss(emits, final):
        return torch.mean((emits[pi] - torch.from_numpy(target)) ** 2)

    _, jem = jax.jit(jep)(jsim.params, xs, jsim.model.initial_state())
    with torch.no_grad():
        _, pem = pep(params, xs, psim.model.initial_state())
    assert pem[pi].shape == (n, 1)
    assert _rel(pem[pi].numpy(), jem[pi]) <= 1e-5
    path = f"probe/{pi}/D"
    want = _jax_leaf(jax.grad(jloss)(jsim.params), path)
    got = _port_grad(pep, params, xs, psim.model.initial_state(), path,
                     ploss)
    assert np.linalg.norm(want) > 0
    assert _rel(got, want) <= GRAD_TOL


def test_remat_matches_plain_and_checks_segments():
    """Checkpointed segments change memory, not math: the gradient of the
    recurrent-free readout through 120 LIFRate steps with segments of 30
    equals the plain loop's within 1e-6 relative; segments that do not
    divide the episode raise."""
    n = 120
    net, p = _net(pnef, pnef.LIFRate(), n, 40)
    sim = pnef.Simulator(net, seed=3, device="cpu")
    xs = ptrain.episode_inputs(sim, n)
    pi = ptrain.probe_index(sim, p)
    target = torch.from_numpy(0.5 * _sine_table(n))

    def loss(emits, final):
        return torch.mean((emits[pi] - target) ** 2)

    grads = [_port_grad(ptrain.make_episode_fn(sim, n, segment_steps=s,
                                               remat=remat),
                        sim.params, xs, sim.model.initial_state(),
                        f"ens/0/bias", loss)
             for s, remat in ((30, True), (120, False))]
    assert np.linalg.norm(grads[1]) > 0
    assert _rel(grads[0], grads[1]) <= 1e-6
    with pytest.raises(ValueError, match="multiple of segment_steps"):
        ptrain.make_episode_fn(sim, 100, segment_steps=33)


def test_partition_merge_roundtrip_paths_match_jax():
    """partition_params selects by the JAX package's slash paths: the same
    leaf paths in both packages' trees; one trainable leaf; merge restores
    every leaf (the same tensor objects)."""
    jsim, jp, psim, pp, params, _, _ = _both(jnef.LIFRate(), pnef.LIFRate(),
                                             100, n_neurons=20)
    jpaths = sorted(jtrain._path_str(path) for path, _ in
                    jax.tree_util.tree_flatten_with_path(jsim.params)[0])
    ppaths = sorted(s for s, _ in ptrain._leaves_with_paths(psim.params))
    assert jpaths == ppaths
    pi = ptrain.probe_index(psim, pp)
    tr, fz = ptrain.partition_params(psim.params,
                                     lambda s: s == f"probe/{pi}/D")
    t_leaves = [x for _, x in ptrain._leaves_with_paths(tr) if x is not None]
    assert len(t_leaves) == 1
    merged = ptrain.merge_params(tr, fz)
    ref = ptrain._leaves_with_paths(psim.params)
    got = ptrain._leaves_with_paths(merged)
    assert [s for s, _ in ref] == [s for s, _ in got]
    assert all(a is b for (_, a), (_, b) in zip(ref, got))


def test_batched_episode_matches_per_episode():
    """The step under vmap inside each checkpointed segment is
    episode-independent: each batch member's trace and final state equal
    the single-episode run on its inputs (1e-6 relative), and the
    gradient of a loss over the batch equals the sum of the per-episode
    gradients (1e-5 relative)."""
    n = 100
    net, p = _net(pnef, pnef.LIFRate(), n, 30)
    sim = pnef.Simulator(net, seed=3, device="cpu")
    pi = ptrain.probe_index(sim, p)
    xs1 = ptrain.episode_inputs(sim, n)
    xs_b = np.stack([0.5 * xs1, xs1, -xs1])
    bep = ptrain.make_batched_episode_fn(sim, n, segment_steps=50)
    ep = ptrain.make_episode_fn(sim, n, segment_steps=50)
    state_b = ptrain.batched_initial_state(sim, 3)
    with torch.no_grad():
        fin_b, em_b = bep(sim.params, xs_b, state_b)
    assert em_b[pi].shape == (3, n, 1)
    target = torch.from_numpy(_sine_table(n))

    def loss(emits, final):
        return torch.sum((emits[pi] - target) ** 2)

    g_sum = 0
    for b in range(3):
        with torch.no_grad():
            fin_1, em_1 = ep(sim.params, xs_b[b], sim.model.initial_state())
        assert _rel(em_b[pi][b].numpy(), em_1[pi].numpy()) <= 1e-6
        assert _rel(fin_b["filters"][0][b].numpy(),
                    fin_1["filters"][0].numpy()) <= 1e-6
        g_sum = g_sum + _port_grad(ep, sim.params, xs_b[b],
                                   sim.model.initial_state(),
                                   f"probe/{pi}/D", loss)
    g_b = _port_grad(bep, sim.params, xs_b, state_b, f"probe/{pi}/D", loss)
    assert _rel(g_b, g_sum) <= 1e-5


# ---------------------------------------------------------------------------
# Meta-learning, fit and the parameter paths
# ---------------------------------------------------------------------------

def _assoc_net(n, d=4):
    """An AssociativeMemory learning two key -> value pairs (alternating
    every 50 steps) by PES, recall probed (tests/test_train.py's network,
    smaller)."""
    rng = np.random.default_rng(0)
    keys = rng.normal(size=(2, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    vals = rng.normal(size=(2, d)).astype(np.float32)
    vals /= 2 * np.linalg.norm(vals, axis=1, keepdims=True)
    idx = (np.arange(n) // 50) % 2

    def make(nef):
        if nef is jnef:
            from sspslam_tpu.models import AssociativeMemory
            from sspslam_tpu.utils import sparsity_to_x_intercept
        else:
            from sspslam_tpu_torch.models import AssociativeMemory
            from sspslam_tpu_torch.utils import sparsity_to_x_intercept
        with nef.Network(seed=0) as net:
            k_in = nef.Node(nef.TimeTable(keys[idx], 0.001))
            v_in = nef.Node(nef.TimeTable(vals[idx], 0.001))
            gate = nef.Node(nef.TimeTable(np.zeros((n, 1), np.float32),
                                          0.001))
            am = AssociativeMemory(80, d, d, sparsity_to_x_intercept(d, 0.25),
                                   voja=False, pes_learning_rate=2e-3, seed=0)
            nef.Connection(k_in, am.key_input, synapse=None)
            nef.Connection(v_in, am.value_input, synapse=None)
            nef.Connection(gate, am.learning, synapse=None)
            p = nef.Probe(am.recall, synapse=0.02)
        return net, p, am
    return make, vals[idx]


def test_learning_rate_gradient_through_pes_matches_jax():
    """d(recall loss)/d(PES learning rate) through 200 steps of online
    learning (rate neurons) against ``jax.grad``, within GRAD_TOL
    relative; the path names the same slot in both packages."""
    n = 200
    make, target = _assoc_net(n)
    jsim, jp, psim, pp, params, jam, pam = _both(
        None, None, n, net_fn=make,
        default_neuron_type=(jnef.LIFRate(), pnef.LIFRate()))
    path = ptrain.learning_rate_path(psim, pam.conn_out)
    assert path == jtrain.learning_rate_path(jsim, jam.conn_out)
    assert path.startswith("hyper/lr/pes_")
    pi = jtrain.probe_index(jsim, jp)
    xs = jtrain.episode_inputs(jsim, n)
    mask = np.zeros((n, 1), np.float32)
    mask[n // 2:] = 1.0
    jep = jtrain.make_episode_fn(jsim, n, segment_steps=50)
    pep = ptrain.make_episode_fn(psim, n, segment_steps=50)

    def jloss(p):
        _, emits = jep(p, xs, jsim.model.initial_state())
        return jnp.sum(mask * (emits[pi] - target) ** 2) / jnp.sum(mask)

    tm, tt = torch.from_numpy(mask), torch.from_numpy(target)

    def ploss(emits, final):
        return torch.sum(tm * (emits[pi] - tt) ** 2) / torch.sum(tm)

    want = _jax_leaf(jax.grad(jloss)(jsim.params), path)
    got = _port_grad(pep, params, xs, psim.model.initial_state(), path,
                     ploss)
    assert want != 0.0
    assert _rel(got, want) <= GRAD_TOL


def test_fit_loss_sequence_matches_jax_keep_best():
    """fit trains only the probe decoders toward -2·x(t): the port's loss
    sequence with Adam(1e-4) against the JAX package's fit with
    optax.adam(1e-4) from the same start, 20 steps, each loss within 5e-4
    relative (Adam divides each gradient by its own magnitude, so float32
    differences of the gradients grow along the sequence); keep_best
    returns the same best iterate (1e-4 relative), and the loss fell by
    more than 2x."""
    n = 200
    jsim, jp, psim, pp, params, _, _ = _both(jnef.LIFRate(), pnef.LIFRate(),
                                             n, n_neurons=50)
    pi = jtrain.probe_index(jsim, jp)
    path = f"probe/{pi}/D"
    xs = jtrain.episode_inputs(jsim, n)
    target = -2.0 * _sine_table(n)
    mask = (np.arange(n) >= 50).astype(np.float32)[:, None]
    tm, tt = torch.from_numpy(mask), torch.from_numpy(target)
    jp2, jl = jtrain.fit(
        jtrain.make_episode_fn(jsim, n, segment_steps=50), jsim.params, xs,
        jsim.model.initial_state(),
        lambda e, f: jnp.sum(mask * (e[pi] - target) ** 2) / jnp.sum(mask),
        trainable=lambda s: s == path, optimizer=optax.adam(1e-4),
        steps=20, keep_best=True)
    seen = []
    pp2, pl = ptrain.fit(
        ptrain.make_episode_fn(psim, n, segment_steps=50), params, xs,
        psim.model.initial_state(),
        lambda e, f: torch.sum(tm * (e[pi] - tt) ** 2) / torch.sum(tm),
        trainable=lambda s: s == path,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-4), steps=20,
        callback=lambda i, loss: seen.append((i, loss)), keep_best=True)
    assert seen == list(enumerate(pl))
    np.testing.assert_allclose(pl, jl, rtol=5e-4)
    assert pl[-1] < pl[0] / 2
    assert _rel(_jax_leaf(pp2, path), _jax_leaf(jp2, path)) <= 1e-4
    # fit copied the trainable leaf: the given params are unchanged
    assert torch.equal(_jax_leaf_t(params, path),
                       torch.from_numpy(np.array(_jax_leaf(jsim.params, path))))


def _jax_leaf_t(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_keep_best_when_the_optimizer_diverges():
    """With a diverging optimizer (SGD at 5.0), keep_best returns the
    lowest-loss iterate seen, not the worse final one."""
    n = 120
    net, p = _net(pnef, pnef.LIFRate(), n, 30)
    sim = pnef.Simulator(net, seed=3, device="cpu")
    ep = ptrain.make_episode_fn(sim, n, segment_steps=60)
    xs = ptrain.episode_inputs(sim, n)
    pi = ptrain.probe_index(sim, p)
    target = torch.from_numpy(-_sine_table(n))

    def loss(emits, final):
        return torch.mean((emits[pi] - target) ** 2)

    best, losses = ptrain.fit(ep, sim.params, xs, sim.model.initial_state(),
                              loss, trainable=lambda s: s == f"probe/{pi}/D",
                              optimizer=lambda ps: torch.optim.SGD(ps, 5.0),
                              steps=12, keep_best=True)
    assert not (losses[-1] <= min(losses))
    with torch.no_grad():
        _, emits = ep(best, xs, sim.model.initial_state())
    assert float(loss(emits, None)) <= min(losses) + 1e-6


def test_parameter_path_errors():
    """connection_param_path raises for a PES-learned connection (its
    decoders are state) and names the learning-rate path instead;
    learning_rate_path raises for an unlearned connection; a group-decoded
    connection raises; the paths agree with the JAX package's."""
    def make(nef):
        with nef.Network(seed=0) as net:
            inp = nef.Node(nef.TimeTable(_sine_table(50)))
            a = nef.Ensemble(30, 1, neuron_type=nef.LIFRate())
            b = nef.Ensemble(30, 1, neuron_type=nef.LIFRate())
            nef.Connection(inp, a, synapse=None)
            plain = nef.Connection(a, b, synapse=0.01)
            c = nef.Connection(a, b, function=lambda x: x * 0,
                               learning_rule_type=nef.PES(1e-3))
            nef.Connection(inp, c.learning_rule, transform=-1, synapse=0.005)
            p = nef.Probe(b)
        return net, p, (plain, c)
    jsim, _, psim, _, _, (jplain, jc), (pplain, pc) = _both(
        None, None, 50, net_fn=make)
    with pytest.raises(ValueError, match="learning_rate_path"):
        ptrain.connection_param_path(psim, pc)
    assert (ptrain.connection_param_path(psim, pplain)
            == jtrain.connection_param_path(jsim, jplain))
    path = ptrain.learning_rate_path(psim, pc)
    assert path == jtrain.learning_rate_path(jsim, jc)
    tr, _ = ptrain.partition_params(psim.params, lambda s: s == path)
    assert sum(x is not None for _, x in ptrain._leaves_with_paths(tr)) == 1
    with pytest.raises(ValueError, match="no PES/Voja"):
        ptrain.learning_rate_path(psim, pplain)
    with pytest.raises(ValueError, match="batched group einsum"):
        _group_decoded_path()


def _group_decoded_path():
    """connection_param_path of a connection decoded through a fused
    group's batched einsum (two same-shaped ensembles, fused into one
    group, each decoded to a node of the same width)."""
    with pnef.Network(seed=0) as net:
        inp = pnef.Node(pnef.TimeTable(_sine_table(20)))
        conns = []
        for _ in range(2):
            ens = pnef.Ensemble(20, 1, neuron_type=pnef.LIFRate())
            pnef.Connection(inp, ens, synapse=None)
            conns.append(pnef.Connection(ens, pnef.Node(size_in=1),
                                         synapse=None))
    sim = pnef.Simulator(net, seed=0, device="cpu")
    return ptrain.connection_param_path(sim, conns[0])


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

PI_ARGS = ("--ssp-dim", "13", "--pi-n-neurons", "40", "--T-steps", "200",
           "--fit-steps", "3", "--segment-steps", "50")
# T = 0.5 s: the gate first corrects before then, so the meta-gradient
# is nonzero (at T = 0.3 s it is exactly 0 and Adam moves nothing)
SLAM_ARGS = ("--T", "0.5", "--ssp-dim", "13", "--pi-n-neurons", "30",
             "--mem-n-neurons", "40", "--cc-n-neurons", "10",
             "--n-landmarks", "4", "--fit-steps", "1", "--segment-steps",
             "100")
# the JAX train_slam's loss and its gradient with respect to the three
# tuned scalars at the start, as train_slam's first meta-step takes it
# (argv: the SLAM_ARGS widths); prints one JSON object
_JAX_META_GRADIENT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platforms", "cpu")
from sspslam_tpu import train
from sspslam_tpu.nef import LIFRate
from experiments.tune_loop_closure import build_sim, make_world
T, d, pi_n, mem_n, cc_n, n_lm, seg = (float(a) for a in sys.argv[1:])
cfg = dict(update_thres=0.5, shift_rate=0.1, voja_lr=5e-4, pes_lr=1e-2,
           intercept=None)
world = make_world(T, 1, n_landmarks=int(n_lm), view_rad=0.3,
                   ssp_dim=int(d))
sim, probe = build_sim(world, cfg, 0, pi_n=int(pi_n), mem_n=int(mem_n),
                       cc_n=int(cc_n), default_neuron_type=LIFRate())
n = world["n_steps"]
targ = world["space"].encode(world["path"]).astype(np.float32)
ep = train.make_episode_fn(sim, n, segment_steps=int(seg))
xs = train.episode_inputs(sim, n)
pidx = train.probe_index(sim, probe)
slam = next(x for x in sim.model.network.networks
            if type(x).__name__ == "SLAMNetwork")
paths = {train.learning_rate_path(sim, slam.assomemory.conn_out): "pes_lr",
         train.learning_rate_path(sim, slam.assomemory.conn_in): "voja_lr"}
hkey = next(k for k, v in sim.model.hoisted.items() if "shift_rate" in v)
paths[f"hoisted/{hkey}/shift_rate"] = "shift_rate"
tr, fz = train.partition_params(sim.params, lambda s: s in paths)
mask = (np.arange(n) >= n // 4).astype(np.float32)[:, None]

def loss(tr):
    _, em = ep(train.merge_params(tr, fz), xs, sim.model.initial_state())
    return jnp.sum(mask * (em[pidx] - targ) ** 2) / jnp.sum(mask)
g = jax.grad(loss)(tr)
print(json.dumps({paths[train._path_str(p)]: float(np.asarray(x))
                  for p, x in jax.tree_util.tree_flatten_with_path(g)[0]
                  if train._path_str(p) in paths}))
"""
# the two packages' meta-gradients through T = 0.5 s of rate dynamics:
# LIFRate's slope is unbounded at threshold, so the executors' different
# roundings grow over the episode (measured 9e-4 of the largest component)
META_GRAD_TOL = 5e-3


def _numbers(line):
    """The numbers of a printed line, in order."""
    import re
    return [float(x) for x in
            re.findall(r"-?\d+\.\d+(?:e-?\d+)?", line.split(":", 1)[1])]


def _lines(stdout, prefixes):
    return {p: next(line for line in stdout.splitlines()
                    if line.startswith(p)) for p in prefixes}


def test_train_clis_match_jax():
    """train_pathint and train_slam at a tiny width on the CPU: the JAX
    CLIs as children, the port's ``main`` in this process.  The lstsq
    errors, the first loss and the swept scalars print the same digits;
    the errors after fitting within 2e-3 (train_pathint) and 5e-3
    (train_slam) absolute; the tuned scalars within 1e-3 relative (Adam
    moves each by about its rate per step); train_slam's first
    meta-gradient finite, nonzero and within META_GRAD_TOL of the JAX
    package's (relative to its largest component)."""
    import ast
    from sspslam_tpu_torch.experiments import train_pathint, train_slam
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               SSPSLAM_CLEANUP_F32="1", OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, str(REPO / "experiments" / f"{name}.py"), "--cpu",
         *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, args in (("train_pathint", PI_ARGS),
                           ("train_slam", SLAM_ARGS))}
    widths = [SLAM_ARGS[SLAM_ARGS.index(f) + 1] for f in (
        "--T", "--ssp-dim", "--pi-n-neurons", "--mem-n-neurons",
        "--cc-n-neurons", "--n-landmarks", "--segment-steps")]
    procs["meta_gradient"] = subprocess.Popen(
        [sys.executable, "-c", _JAX_META_GRADIENT, *widths], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    os.environ["SSPSLAM_CLEANUP_F32"] = "1"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the port's small ops: one thread is fastest
    try:
        for name, cli, args in (("train_pathint", train_pathint, PI_ARGS),
                                ("train_slam", train_slam, SLAM_ARGS)):
            with contextlib.redirect_stdout(io.StringIO()) as out:
                cli.main(["--device", "cpu", *args])
            port[name] = out.getvalue()
    finally:
        del os.environ["SSPSLAM_CLEANUP_F32"]
        torch.set_num_threads(threads)
    ref = {}
    for name, proc in procs.items():
        ref[name], stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])

    keys = ("lstsq-solved:", "fit:", "backprop-tuned:", "held-out")
    p, j = (_lines(out["train_pathint"], keys) for out in (port, ref))
    assert p["lstsq-solved:"] == j["lstsq-solved:"]
    pf, jf = _numbers(p["fit:"]), _numbers(j["fit:"])
    assert pf[1] == jf[1]                                  # first loss
    assert abs(pf[2] - jf[2]) <= 1e-3 * jf[2]             # last loss
    np.testing.assert_allclose(_numbers(p["backprop-tuned:"]),
                               _numbers(j["backprop-tuned:"]), atol=2e-3)

    keys = ("trainable:", "swept defaults", "fit:", "tuned:",
            "gradient-tuned:")
    p, j = (_lines(out["train_slam"], keys) for out in (port, ref))
    scal = [ast.literal_eval(d["trainable:"].split(":", 1)[1].strip())
            for d in (p, j)]
    assert scal[0] == scal[1]
    assert p["swept defaults"] == j["swept defaults"]
    assert _numbers(p["fit:"])[1] == _numbers(j["fit:"])[1]
    tuned = [ast.literal_eval(d["tuned:"].split(":", 1)[1].strip())
             for d in (p, j)]
    assert tuned[0].keys() == tuned[1].keys()
    for k in tuned[1]:
        assert tuned[0][k] >= 0
        assert abs(tuned[0][k] - tuned[1][k]) <= 1e-3 * tuned[1][k], k
    np.testing.assert_allclose(_numbers(p["gradient-tuned:"]),
                               _numbers(j["gradient-tuned:"]), atol=5e-3)
    got = ast.literal_eval(_lines(port["train_slam"], (
        "first meta-gradient:",))["first meta-gradient:"].split(":", 1)[1]
        .strip())
    want = json.loads(ref["meta_gradient"].strip().splitlines()[-1])
    assert got.keys() == want.keys() == tuned[1].keys()
    g, w = (np.array([d[k] for k in sorted(want)]) for d in (got, want))
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0
    assert _rel(g, w) <= META_GRAD_TOL, (got, want)


TUNE_ARGS = ("--quick", "--T", "0.5", "--final-T", "0.5", "--top", "1",
             "--ssp-dim", "13", "--pi-n-neurons", "30", "--mem-n-neurons",
             "40", "--circonv-n-neurons", "10", "--n-landmarks", "4")


def test_tune_loop_closure_sweep_matches_jax():
    """tune_loop_closure --quick at a tiny width on the CPU, the JAX CLI as
    a child and the port's ``main`` in this process: every printed line
    (the eight rows' errors to 3 digits, the best gate, the ranking) is
    the same but for each row's seconds.  At T = 0.5 s the settings give
    different rows, so the in-place configuration of each is seen."""
    import re
    from sspslam_tpu_torch.experiments import tune_loop_closure
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               SSPSLAM_CLEANUP_F32="1", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "experiments" / "tune_loop_closure.py"),
         "--cpu", *TUNE_ARGS], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    os.environ["SSPSLAM_CLEANUP_F32"] = "1"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            tune_loop_closure.main(["--device", "cpu", *TUNE_ARGS])
    finally:
        del os.environ["SSPSLAM_CLEANUP_F32"]
        torch.set_num_threads(threads)
    ref, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]

    def lines(text):
        return [re.sub(r" \(\d+s\)$", "", line)
                for line in text.splitlines()]
    got, want = lines(out.getvalue()), lines(ref)
    assert got == want
    rows = [line for line in got if line.startswith("[s")]
    assert len(rows) == 8
    assert len({line.split("->")[1] for line in rows}) > 1


def test_tune_loop_closure_in_place_config_equals_a_fresh_build():
    """tune_loop_closure's sweep writes a configuration's learning rates
    and gate scalars into the params in place: the run that follows equals
    the run of a simulator built with that configuration (the same
    errors, the same trace), and a second run of the same simulator
    repeats itself (the preloaded world is kept)."""
    from sspslam_tpu_torch.experiments import tune_loop_closure as tlc
    world = tlc.make_world(0.3, 1, n_landmarks=4, view_rad=0.3, ssp_dim=13)
    base = dict(update_thres=0.2, shift_rate=0.2, voja_lr=1e-4, pes_lr=5e-3,
                intercept=0.1)
    cfg = dict(base, update_thres=0.4, shift_rate=0.5, pes_lr=2e-2,
               voja_lr=5e-4)
    kw = dict(pi_n=30, mem_n=40, cc_n=10, device="cpu")
    sim, p = tlc.build_sim(world, base, 0, **kw)
    fresh, fp = tlc.build_sim(world, cfg, 0, **kw)
    tlc.configure(sim, cfg)
    got = tlc.run_config(sim, p, world, segment_steps=100)
    trace = sim.data[p]
    assert got == tlc.run_config(fresh, fp, world, segment_steps=100)
    np.testing.assert_array_equal(trace, fresh.data[fp])
    assert tlc.run_config(sim, p, world, segment_steps=100) == got
    assert sim.n_steps == world["n_steps"] == 300


def test_tie_splitting_clip_keeps_the_forward_ops(monkeypatch):
    """The neuron steps' clips split the gradient like JAX's at ties but
    run the same forward ops as ``torch.clamp``: for each neuron type the
    ATen calls of one step (no grad, the Simulator's case) and its outputs
    are those of the step with plain ``torch.clamp`` clips, bit for bit;
    under grad the forward adds only ``detach`` views (no kernel) for the
    tensors the backward pass keeps."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(1)
    J = torch.from_numpy(rng.uniform(-1, 3, (4, 32)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(0, 1.2, (4, 32)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(0, 0.003, (4, 32)).astype(np.float32))

    def run(nt, grad):
        state = ({"voltage": v.clone(), "refractory": r.clone()}
                 if nt.spiking else {})
        Jx = J.clone().requires_grad_(grad)
        with Calls() as calls:
            new, out = nt.step(state, Jx, 0.001)
        return calls.ops, [out.detach()] + [x.detach() for x in new.values()]

    types = (pneurons.LIF(), pneurons.LIFRate(), pneurons.RectifiedLinear(),
             pneurons.SpikingRectifiedLinear(), pneurons.LoihiLIF(),
             pneurons.SurrogateLIF())
    got = {type(nt).__name__: (run(nt, False), run(nt, True)) for nt in types}
    monkeypatch.setattr(pneurons, "_clip",
                        lambda x, lo=None, hi=None: torch.clamp(x, lo, hi))
    for nt in types:
        (ops, outs), (grad_ops, _) = got[type(nt).__name__]
        want_ops, want = run(nt, False)
        assert ops == want_ops, type(nt).__name__
        assert [op for op in grad_ops if op != "aten.detach.default"] \
            == want_ops, type(nt).__name__
        for a, b in zip(outs, want):
            assert torch.equal(a, b), type(nt).__name__


@pytest.mark.parametrize("cli, args", [
    ("train_pathint", ()), ("train_slam", ()),
    ("tune_loop_closure", ("--T", "1", "--final-T", "1")),
    ("closed_loop_nav", ())])
def test_clis_default_to_the_card(cli, args):
    """Each new CLI runs on the CUDA device unless ``--device`` names
    another: without a card it raises instead of falling back."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    module = importlib.import_module(f"sspslam_tpu_torch.experiments.{cli}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(list(args))
