"""The NEF builder, solvers, neurons and synapses: the torch port against
the JAX package.

Both builders draw from the same NumPy seed streams, so gains, biases,
encoders and eval points must be bitwise equal; host decoder solves are the
same NumPy code (held to 1e-6 relative); the float32 device solves, torch
against JAX on the CPU, agree to 1e-4 relative (Cholesky in float32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sspslam_tpu import HexagonalSSPSpace as JaxHexagonalSSPSpace
from sspslam_tpu import nef as jnef
from sspslam_tpu.models import PathIntegration as JaxPathIntegration
from sspslam_tpu.nef import builder as jax_builder
from sspslam_tpu.nef import solvers as jax_solvers
from sspslam_tpu.ops import neurons as jax_neurons
from sspslam_tpu.ops import synapses as jax_synapses

import sspslam_tpu_torch.nef as tnef
from sspslam_tpu_torch import HexagonalSSPSpace
from sspslam_tpu_torch.models import PathIntegration
from sspslam_tpu_torch.nef import builder, solvers
from sspslam_tpu_torch.ops import neurons, synapses

HOST_DECODER_RTOL = 1e-6    # same NumPy solve on both sides
DEVICE_DECODER_RTOL = 1e-4  # float32 normal equations + Cholesky
LIF_TOL = 1e-5              # float32 LIF state; expm1/log1p round by an ulp
                            # differently in XLA and torch, carried 50 steps


def _rel_err(got, ref):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)


def _spaces(ssp_dim=31):
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    kw = dict(ssp_dim=ssp_dim, seed=0, length_scale=0.3, domain_bounds=bounds)
    return JaxHexagonalSSPSpace(2, **kw), HexagonalSSPSpace(2, **kw)


def _build_pathint(n_neurons=48, seed=0, pad=1):
    js, ts = _spaces()
    with jnef.Network(seed=seed) as jnet:
        jnef.Node(size_in=2, output=None, label="vel_stub")
        JaxPathIntegration(js, n_neurons, 0.05, neuron_type=jnef.LIF())
    with tnef.Network(seed=seed) as tnet:
        tnef.Node(size_in=2, output=None, label="vel_stub")
        PathIntegration(ts, n_neurons, 0.05, neuron_type=tnef.LIF())
    jm = jax_builder.build(jnet, dt=0.001, seed=seed, pad_batched_to=pad)
    tm = builder.build(tnet, dt=0.001, seed=seed, pad_batched_to=pad,
                       device="cpu")
    return jm, tm


def _assert_models_match(jm, tm, decoder_rtol):
    assert len(tm.ensembles) == len(jm.ensembles)
    for jb, tb in zip(jm.ensembles, tm.ensembles):
        assert (tb.batched, tb.k, tb.n, tb.dim, tb.n_pad) == \
            (jb.batched, jb.k, jb.n, jb.dim, jb.n_pad)
        for f in ("gain", "bias", "encoders", "scaled_encoders",
                  "eval_points"):
            assert np.array_equal(getattr(tb, f), getattr(jb, f)), f
    assert len(tm.connections) == len(jm.connections)
    for jc, tc in zip(jm.connections, tm.connections):
        assert (tc.pre_kind, tc.post_kind, tc.filt_index, tc.ea_rows) == \
            (jc.pre_kind, jc.post_kind, jc.filt_index, jc.ea_rows)
        if jc.weights is None:
            assert tc.weights is None
        else:
            assert np.array_equal(tc.weights, jc.weights)
        assert tc.scalar_weight == jc.scalar_weight
        if jc.decoders is None:
            assert tc.decoders is None
        else:
            assert _rel_err(tc.decoders, jc.decoders) <= decoder_rtol
    assert tm.filter_specs == jm.filter_specs
    assert [k for k, _ in tm.topo_units] == [k for k, _ in jm.topo_units]


@pytest.mark.parametrize("pad", [1, 4])
def test_pathintegration_build_matches(pad):
    jm, tm = _build_pathint(pad=pad)
    _assert_models_match(jm, tm, HOST_DECODER_RTOL)
    be = next(b for b in tm.ensembles if b.batched)
    assert be.k == 13 + (-13 % pad)   # ssp_dim 25 -> 13 VCOs


def test_pathintegration_build_device_solve(monkeypatch):
    """The full-width path: the VCO bank's batched solve runs on the device
    (here the CPU) and its decoders stay tensors through the builder."""
    monkeypatch.setattr(jax_builder, "DEVICE_SOLVE_MIN_BATCH_ELEMS", 0)
    monkeypatch.setattr(builder, "DEVICE_SOLVE_MIN_BATCH_ELEMS", 0)
    jm, tm = _build_pathint()
    rec = next(c for c in tm.connections
               if c.pre_kind == "ea_batch" and c.post_kind == "ea_batch")
    assert torch.is_tensor(rec.decoders)
    assert float(rec.decoders[0].abs().max()) == 0.0   # DC VCO masked
    _assert_models_match(jm, tm, DEVICE_DECODER_RTOL)


def test_mixed_network_build_matches():
    """Single ensembles (fused into one group), a function connection, a
    tabulated node, a filtered probe and an Alpha synapse."""
    def build_with(pkg, build_fn):
        with pkg.Network(seed=3) as net:
            stim = pkg.Node(lambda t: [np.sin(t), np.cos(t)])
            a = pkg.Ensemble(60, 2, radius=1.5)
            b = pkg.Ensemble(60, 2, radius=1.5)
            c = pkg.Ensemble(40, 1, intercepts=pkg.Uniform(-0.5, 0.5))
            pkg.Connection(stim, a, synapse=None)
            pkg.Connection(a, b, function=lambda x: x ** 2,
                           synapse=pkg.Alpha(0.01))
            pkg.Connection(b, c, transform=np.array([[0.5, -0.5]]))
            # a computed node of unknown output size: the builder calls
            # it once (JAX: on NumPy zeros; the port: on CPU tensors)
            f = pkg.Node(lambda t, x: x[:1] * 2, size_in=2)
            pkg.Connection(b, f)
            pkg.Probe(c, synapse=0.02)
        model = build_fn(net)
        return model, f

    jm, jf = build_with(jnef, lambda n: jax_builder.build(n, dt=0.001))
    tm, tf = build_with(tnef, lambda n: builder.build(n, dt=0.001,
                                                      device="cpu"))
    assert tf.size_out == jf.size_out == 1
    _assert_models_match(jm, tm, HOST_DECODER_RTOL)
    assert tm.filter_cascade == jm.filter_cascade
    assert len(tm.probes) == len(jm.probes) == 1
    assert np.array_equal(tm.probes[0].decoders, jm.probes[0].decoders)


def _solve_inputs(k=5, n=40, P=300, dim=3, seed=0):
    rng = np.random.default_rng(seed)
    nt = neurons.LIF()
    max_rates = rng.uniform(200, 400, size=(k, n))
    intercepts = rng.uniform(-1, 0.9, size=(k, n))
    gain, bias = nt.gain_bias(max_rates, intercepts)
    enc = rng.normal(size=(k, n, dim))
    enc /= np.linalg.norm(enc, axis=-1, keepdims=True)
    E = enc * gain[..., None]
    ep = rng.uniform(-1, 1, size=(P, dim))
    Y = np.stack([np.sin(ep[:, 0]) * ep[:, 1], ep[:, 2] ** 2], axis=1)
    return E, bias, ep, Y


@pytest.mark.parametrize("per_elem", [False, True])
def test_batched_device_solve_matches_jax(per_elem):
    E, b, ep, Y = _solve_inputs()
    if per_elem:   # fused groups carry (k, P, dim) eval points and targets
        ep = np.stack([ep + 0.01 * j for j in range(E.shape[0])])
        Y = np.stack([Y * (1 + 0.1 * j) for j in range(E.shape[0])])
    ref = jax_solvers.solve_decoders_batched_on_device(
        jax_neurons.LIF(), E, b, ep, Y, reg=0.1)
    got = solvers.solve_decoders_batched_on_device(
        neurons.LIF(), E, b, ep, Y, reg=0.1, device="cpu")
    assert got.shape == (E.shape[0], E.shape[1], 2)
    assert got.dtype == torch.float32
    assert _rel_err(got, ref) <= DEVICE_DECODER_RTOL


def test_single_device_solve_matches_jax():
    E, b, ep, Y = _solve_inputs(k=1, n=120)
    ref = jax_solvers.solve_decoders_on_device(
        jax_neurons.LIF(), E[0], b[0], ep, Y, reg=0.1)
    got = solvers.solve_decoders_on_device(
        neurons.LIF(), E[0], b[0], ep, Y, reg=0.1, device="cpu")
    assert _rel_err(got, ref) <= DEVICE_DECODER_RTOL


def test_host_solves_bitwise():
    E, b, ep, Y = _solve_inputs()
    nt = neurons.LIF()
    J = (ep @ np.swapaxes(E, 1, 2) + b[:, None, :]).astype(np.float32)
    acts = nt.rates_np(J).astype(np.float32)
    assert np.array_equal(solvers.lstsq_l2_batched(acts, Y),
                          jax_solvers.lstsq_l2_batched(acts, Y))
    assert np.array_equal(solvers.lstsq_l2(acts[0], Y),
                          jax_solvers.lstsq_l2(acts[0], Y))


def test_lif_rates_and_gain_bias():
    rng = np.random.default_rng(2)
    t, j = neurons.LIF(tau_rc=0.03), jax_neurons.LIF(tau_rc=0.03)
    mr, ic = rng.uniform(200, 400, 50), rng.uniform(-1, 0.9, 50)
    for a, b in zip(t.gain_bias(mr, ic), j.gain_bias(mr, ic)):
        assert np.array_equal(a, b)
    J = rng.uniform(-1, 4, size=(30, 7)).astype(np.float32)
    assert np.array_equal(t.rates_np(J), j.rates_np(J))
    np.testing.assert_allclose(t.rates(torch.tensor(J)).numpy(),
                               np.asarray(j.rates(jnp.asarray(J))),
                               rtol=LIF_TOL)


def test_lif_step_matches_executor_lif():
    """The port's LIF.step (shared by the kernel's plain version) against
    the JAX executor's LIF.step, over 50 steps of random current."""
    rng = np.random.default_rng(4)
    t, j = neurons.LIF(), jax_neurons.LIF()
    shape = (64, 9)
    ts = {k: torch.tensor(v) for k, v in t.init_state(shape).items()}
    js = {k: jnp.asarray(v) for k, v in j.init_state(shape).items()}
    n_spikes = 0
    for _ in range(50):
        J = rng.uniform(0, 6, size=shape).astype(np.float32)
        ts, tout = t.step(ts, torch.tensor(J), 0.001)
        js, jout = j.step(js, jnp.asarray(J), 0.001)
        assert np.array_equal(tout.numpy(), np.asarray(jout))
        for k in ("voltage", "refractory"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=0, atol=LIF_TOL)
        n_spikes += int((tout > 0).sum())
    assert n_spikes > 100


@pytest.mark.parametrize("syn", [None, 0.0, 0.005, 0.05, "alpha"])
def test_synapse_coefficients(syn):
    def make(mod):
        return mod.Alpha(0.02) if syn == "alpha" else syn
    if syn is None:
        with pytest.raises(ValueError):
            synapses.coefficients(None, 0.001)
        return
    assert synapses.coefficients(make(synapses), 0.001) == \
        jax_synapses.coefficients(make(jax_synapses), 0.001)
