"""The port's executor (sspslam_tpu_torch.nef.executor) against the JAX
package's: the same network built by each package, the port given the JAX
parameters through params_from_numpy, both steps advanced step by step on
the same inputs (the JAX step jitted, the port's eager on the CPU).  Cases
mirror tests/test_nef.py at smaller sizes.  Bounds (tests/torch_parity.py):
rate networks max-abs <= 1e-4, spiking networks the spike-flip bounds of
tests/test_backends.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_runs_match, host_params, leaves,
                          step_both)

import sspslam_tpu.nef as jnef
from sspslam_tpu.nef import Simulator as JaxSimulator

import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.nef.builder import build as port_build
from sspslam_tpu_torch.nef.executor import (build_params, make_step_fn,
                                            params_from_numpy)

PACKAGES = ((jnef, jnp), (pnef, torch))


def both(make):
    """``make(nef, xp)`` for the JAX package (nef, jnp) and the port
    (nef, torch); returns the two networks."""
    return [make(nef, xp) for nef, xp in PACKAGES]


def _channel(nt_name):
    def make(nef, xp):
        val = np.array([0.4, -0.3])
        with nef.Network(seed=1) as net:
            inp = nef.Node(lambda t: val)
            ens = nef.Ensemble(80, 2, neuron_type=getattr(nef, nt_name)(),
                               seed=1)
            out = nef.Node(size_in=2)
            nef.Connection(inp, ens, synapse=None)
            nef.Connection(ens, out, synapse=0.02)
            nef.Probe(out)
            nef.Probe(ens.neurons)
        return net
    return make


@pytest.mark.parametrize("nt", ["LIF", "LIFRate", "RectifiedLinear",
                                "SpikingRectifiedLinear", "LoihiLIF",
                                "QuantizedLIF"])
def test_channel(nt):
    spiking = nt not in ("LIFRate", "RectifiedLinear")
    assert_runs_match(*both(_channel(nt)), 200, seed=1, spiking=spiking)


def test_decoded_function():
    def make(nef, xp):
        with nef.Network(seed=2) as net:
            inp = nef.Node(lambda t: np.array([np.sin(8 * t)]))
            ens = nef.Ensemble(100, 1, neuron_type=nef.LIFRate(), seed=2)
            out = nef.Node(size_in=1)
            nef.Connection(inp, ens, synapse=None)
            nef.Connection(ens, out, function=lambda x: x**2, synapse=0.02)
            nef.Probe(out)
            nef.Probe(ens, synapse=0.01)
        return net
    assert_runs_match(*both(make), 200, seed=2)


def test_sliced_post_and_pre():
    def make(nef, xp):
        with nef.Network(seed=3) as net:
            a = nef.Node(lambda t: np.array([1.0, 2.0, 3.0]))
            b = nef.Node(lambda t: np.array([-1.0]))
            ens = nef.Ensemble(60, 2, neuron_type=nef.LIFRate(), seed=3)
            out = nef.Node(size_in=4)
            nef.Connection(a[[2, 0]], ens, transform=0.2, synapse=None)
            nef.Connection(a[1:], out[0:2], synapse=None)
            nef.Connection(b, out[3], synapse=None)
            nef.Connection(ens[1], out[2], synapse=0.01)
            nef.Probe(out)
        return net
    jout, pout, *_ = assert_runs_match(*both(make), 40, seed=3)
    got = next(iter(pout.values()))
    np.testing.assert_array_equal(got[:, [0, 1, 3]],
                                  np.tile([2.0, 3.0, -1.0], (40, 1)))


def test_repeated_post_indices_accumulate():
    """x.at[idx].add(v) adds every repeated index; the port's scatter-add
    must too (a plain x[idx] += v would keep one of them)."""
    def make(nef, xp):
        with nef.Network(seed=4) as net:
            a = nef.Node(lambda t: np.array([1.0, 2.0, 4.0]))
            out = nef.Node(size_in=3)
            ens = nef.Ensemble(60, 2, neuron_type=nef.LIFRate(), seed=4)
            nef.Connection(a, out[[0, 0, 2]], synapse=None)
            nef.Connection(a[:2], ens[[1, 1]], transform=0.1, synapse=None)
            nef.Probe(out)
            nef.Probe(ens, synapse=0.01)
        return net
    jout, pout, *_ = assert_runs_match(*both(make), 30, seed=4)
    out = pout[0]
    np.testing.assert_array_equal(out, np.tile([3.0, 0.0, 4.0], (30, 1)))


def test_tensor_function_node():
    def make(nef, xp):
        with nef.Network(seed=4) as net:
            inp = nef.Node(lambda t: np.array([0.3, 0.4]) * np.sin(20 * t))
            gate = nef.Node(lambda t, x: xp.where(xp.sum(x) > 0.2, x, 0.0),
                            size_in=2)
            fn = nef.Node(size_in=2)
            nef.Connection(inp, gate, synapse=None)
            nef.Connection(gate, fn, function=lambda v: v * v, synapse=None)
            nef.Probe(gate)
            nef.Probe(fn)
        return net
    jout, pout, *_ = assert_runs_match(*both(make), 100, seed=4)
    assert np.any(pout[0] == 0.0) and np.any(pout[0] != 0.0)


def test_stateful_latch_node():
    def make(nef, xp):
        def latch(t, x, s, consts=None):
            ns = xp.maximum(s, x)
            return ns, ns
        latch.state_init = np.zeros(2, np.float32)
        with nef.Network(seed=0) as net:
            inp = nef.Node(lambda t: np.array([np.sin(7 * t), np.cos(5 * t)]))
            n = nef.Node(latch, size_in=2, size_out=2)
            nef.Connection(inp, n, synapse=None)
            out = nef.Node(size_in=2)
            nef.Connection(n, out, synapse=0.02)
            nef.Probe(out, synapse=None)
        return net
    _, _, _, ps, _ = assert_runs_match(*both(make), 250)
    assert (ps["nodes"]["ns0"].numpy() > 0.9).all()


def test_integrator():
    def make(nef, xp):
        tau = 0.1
        with nef.Network(seed=5) as net:
            inp = nef.Node(lambda t: np.array([0.8 if t < 0.1 else 0.0]))
            ens = nef.Ensemble(100, 1, neuron_type=nef.LIFRate(), seed=5)
            nef.Connection(inp, ens, transform=tau / 0.1, synapse=tau)
            nef.Connection(ens, ens, synapse=tau)
            nef.Probe(ens, synapse=0.02)
        return net
    assert_runs_match(*both(make), 300, seed=5)


def test_oscillator():
    def make(nef, xp):
        tau, w = 0.1, 2 * np.pi * 2.0

        def feedback(x):
            return [x[0] - tau * w * x[1], x[1] + tau * w * x[0]]
        with nef.Network(seed=6) as net:
            kick = nef.Node(lambda t: np.array([1.0, 0.0]) if t < 0.05
                            else np.zeros(2))
            ens = nef.Ensemble(100, 2, neuron_type=nef.LIFRate(), seed=6)
            nef.Connection(kick, ens, synapse=None)
            nef.Connection(ens, ens, function=feedback, synapse=tau)
            nef.Probe(ens, synapse=0.02)
        return net
    assert_runs_match(*both(make), 300, seed=6)


def test_ea_passthrough_and_square():
    def make(nef, xp):
        val = np.linspace(-0.6, 0.6, 6)
        with nef.Network(seed=7) as net:
            inp = nef.Node(lambda t: val)
            ea = nef.EnsembleArray(60, 3, ens_dimensions=2,
                                   neuron_type=nef.LIFRate(), seed=7)
            sq = ea.add_output("square", np.square)
            nef.Connection(inp, ea.input, synapse=None)
            nef.Probe(ea.output, synapse=0.02)
            nef.Probe(sq, synapse=0.02)
        return net
    assert_runs_match(*both(make), 150, seed=7)


def test_batched_recurrent_ea():
    def make(nef, xp):
        k, tau = 4, 0.1
        vals = np.linspace(-0.5, 0.5, k)
        with nef.Network(seed=9) as net:
            inp = nef.Node(lambda t: vals if t < 0.1 else np.zeros(k))
            ea = nef.EnsembleArray(60, k, ens_dimensions=1,
                                   neuron_type=nef.LIFRate(), seed=9)
            nef.Connection(inp, ea.input, transform=tau / 0.1 * np.eye(k),
                           synapse=tau)
            nef.BatchedConnection(ea, ea, function=lambda x: x, synapse=tau)
            nef.Probe(ea.output, synapse=0.02)
        return net
    assert_runs_match(*both(make), 250, seed=9)


def test_lowpass_and_alpha_filters():
    def make(nef, xp):
        with nef.Network(seed=8) as net:
            inp = nef.Node(lambda t: np.array([1.0, np.sin(30 * t)]))
            ens = nef.Ensemble(60, 2, neuron_type=nef.LIFRate(), seed=8)
            out = nef.Node(size_in=2)
            nef.Connection(inp, ens, synapse=nef.Alpha(0.01))
            nef.Connection(ens, out, synapse=nef.Lowpass(0.02))
            nef.Probe(out, synapse=nef.Alpha(0.015))
            nef.Probe(ens, synapse=0.01)
            nef.Probe(inp, synapse=nef.Alpha(0.01))
        return net
    assert_runs_match(*both(make), 150, seed=8)


def _pes(nef, lr=1e-3, nt="LIFRate"):
    val = np.array([0.6, -0.2])
    with nef.Network(seed=10) as net:
        inp = nef.Node(lambda t: val)
        ens = nef.Ensemble(80, 2, neuron_type=getattr(nef, nt)(), seed=10)
        out = nef.Node(size_in=2)
        nef.Connection(inp, ens, synapse=None)
        c = nef.Connection(ens, out, function=lambda x: np.zeros(2),
                           learning_rule_type=nef.PES(lr), synapse=0.02)
        err = nef.Node(size_in=2)
        nef.Connection(out, err, synapse=0.02)
        nef.Connection(inp, err, transform=-1.0, synapse=0.02)
        nef.Connection(err, c.learning_rule, synapse=0.02)
        nef.Probe(out, synapse=0.02)
        nef.Probe(c, attr="weights")
    return net


def test_pes_identity():
    _, pout, *_ = assert_runs_match(*both(lambda nef, xp: _pes(nef)), 300,
                                    seed=10)
    assert np.abs(pout[0][-1]).max() > 0.05   # it learned something


def test_voja_drift():
    def make(nef, xp):
        key = np.array([1.0, 0.0])
        with nef.Network(seed=11) as net:
            inp = nef.Node(lambda t: key)
            ens = nef.Ensemble(50, 2, neuron_type=nef.LIFRate(),
                               intercepts=nef.Uniform(0.1, 0.3), seed=11)
            c = nef.Connection(inp, ens, synapse=None,
                               learning_rule_type=nef.Voja(
                                   5e-2, post_synapse=None))
            nef.Probe(c.learning_rule, attr="scaled_encoders")
            nef.Probe(ens, synapse=0.01)
        return net
    jout, pout, *_ = assert_runs_match(*both(make), 200, seed=11)
    assert not np.allclose(pout[0][0], pout[0][-1])


def test_gated_learning():
    """Voja gated by a node into its learning rule (learning signal
    1 + gate) and a PES error population inhibited through its neurons —
    the AssociativeMemory pattern."""
    def make(nef, xp):
        with nef.Network(seed=12) as net:
            key = nef.Node(lambda t: np.array([np.cos(3 * t), np.sin(3 * t)]))
            gate = nef.Node(lambda t: np.array([0.0 if t < 0.1 else -1.0]))
            value = nef.Node(lambda t: np.array([0.5]))
            mem = nef.Ensemble(60, 2, neuron_type=nef.LIFRate(),
                               intercepts=nef.Uniform(0.2, 0.4), seed=12)
            c_in = nef.Connection(key, mem, synapse=None,
                                  learning_rule_type=nef.Voja(
                                      5e-2, post_synapse=0.005))
            nef.Connection(gate, c_in.learning_rule, synapse=None)
            recall = nef.Node(size_in=1)
            c_out = nef.Connection(mem, recall,
                                   function=lambda x: np.zeros(1),
                                   learning_rule_type=nef.PES(1e-3),
                                   synapse=0.01)
            err = nef.Ensemble(60, 1, neuron_type=nef.LIFRate(), seed=13)
            nef.Connection(gate, err.neurons, transform=2.5 * np.ones((60, 1)),
                           synapse=None)
            nef.Connection(value, err, transform=-1, synapse=0.01)
            nef.Connection(recall, err, synapse=0.01)
            nef.Connection(err, c_out.learning_rule, synapse=0.01)
            nef.Probe(recall, synapse=0.01)
            nef.Probe(c_in.learning_rule, attr="scaled_encoders")
            nef.Probe(c_out, attr="weights")
        return net
    assert_runs_match(*both(make), 200, seed=12)


def test_voltage_probe():
    def make(nef, xp):
        with nef.Network(seed=0) as net:
            inp = nef.Node(lambda t: np.array([0.7]))
            ens = nef.Ensemble(20, 1)
            nef.Connection(inp, ens, synapse=None)
            nef.Probe(ens.neurons, attr="voltage")
            nef.Probe(ens.neurons)
        return net
    _, pout, *_ = assert_runs_match(*both(make), 100, spiking=True)
    assert pout[0].shape == (100, 20) and np.std(pout[0][-1] - pout[0][0]) > 0


def test_bf16_matmuls():
    """matmul_dtype bf16: bf16 storage and matmul inputs, float32
    accumulation, in both packages."""
    assert_runs_match(*both(lambda nef, xp: _pes(nef)), 150, seed=10,
                      jax_matmul=jnp.bfloat16, port_matmul="bf16")
    model = port_build(both(lambda nef, xp: _pes(nef))[1], seed=10,
                       device="cpu")
    params = build_params(model, matmul_dtype="bf16", device="cpu")
    assert params["ens"][0]["scaled_encoders"].dtype == torch.bfloat16
    assert params["ens"][0]["bias"].dtype == torch.float32


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantised_matmul_dtypes_raise(kind):
    net = both(lambda nef, xp: _pes(nef))[1]
    with pytest.raises(NotImplementedError, match="quantize"):
        pnef.Simulator(net, seed=10, matmul_dtype=kind, device="cpu")
    model = port_build(net, seed=10, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6.2"):
        make_step_fn(model, matmul_dtype=kind, device="cpu")


def test_params_from_numpy_equals_own_build():
    """The port's own build_params equals the JAX parameters it is handed
    (the builders agree bitwise), and a tree of another model is
    refused."""
    jnet, pnet = both(lambda nef, xp: _pes(nef))
    jsim = JaxSimulator(jnet, seed=10)
    model = port_build(pnet, seed=10, device="cpu")
    own = build_params(model, device="cpu")
    given = params_from_numpy(model, host_params(jsim.params), device="cpu")
    for a, b in zip(leaves(own), leaves(given)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    other = JaxSimulator(both(_channel("LIF"))[0], seed=1)
    with pytest.raises(ValueError, match="layout"):
        params_from_numpy(model, host_params(other.params), device="cpu")


def test_learning_rate_is_a_tensor_param():
    """Learning rates live in params as tensors: zeroing one in place
    freezes the decoders with the same step function."""
    net = both(lambda nef, xp: _pes(nef))[1]
    sim = pnef.Simulator(net, seed=10, device="cpu")
    slot = next(bc.learned_slot for bc in sim.model.connections
                if bc.pes_rule is not None)
    lr = sim.params["hyper"]["lr"][slot]
    assert torch.is_tensor(lr) and float(lr) == np.float32(1e-3)
    d0 = sim.state["learned"][slot].clone()
    lr.zero_()
    sim.run_steps(100)
    assert torch.equal(sim.state["learned"][slot], d0)
    lr.fill_(1e-3)
    sim.run_steps(100)
    assert not torch.equal(sim.state["learned"][slot], d0)


def test_simulator_stepping_matches_step_by_step():
    """The Simulator's stepping (state tensors written back in place,
    probes into buffers, inputs read from a table) gives the executor's
    step-by-step values bit for bit."""
    jnet, pnet = both(lambda nef, xp: _pes(nef))
    _, pout, *_ = step_both(jnet, pnet, 120, seed=10)
    sim = pnef.Simulator(pnet, seed=10, device="cpu")
    sim.run_steps(120, segment_steps=50)
    for bp in sim.model.probes:
        np.testing.assert_array_equal(sim.data[bp.obj], pout[bp.index])
