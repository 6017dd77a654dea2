"""The port's Simulator bookkeeping on the CPU: the semantics of
tests/test_simulator_semantics.py and of test_nef.py's TestPreloadAndCompile
/ TestSimulatorEdgeCases / TestDevicePreload, each also held to the JAX
Simulator's probe data where both run the same network, and checkpoints
moved between the two packages in both directions.
"""

import numpy as np
import pytest
import torch
from torch_parity import assert_close

import sspslam_tpu.nef as jnef

import sspslam_tpu_torch.nef as pnef


def _ramp(nef, n_steps, sample_every=None, seed=0):
    tab = np.linspace(0, 1, n_steps, dtype=np.float32)[:, None]
    with nef.Network(seed=seed) as net:
        inp = nef.Node(nef.TimeTable(tab, 0.001))
        ens = nef.Ensemble(40, 1, neuron_type=nef.LIFRate())
        nef.Connection(inp, ens, synapse=None)
        p = nef.Probe(ens, synapse=0.01, sample_every=sample_every)
    return net, p


def ramp_sim(n_steps, sample_every=None, seed=0):
    net, p = _ramp(pnef, n_steps, sample_every, seed)
    return pnef.Simulator(net, seed=seed, device="cpu"), p


def jax_ramp_sim(n_steps, sample_every=None, seed=0):
    net, p = _ramp(jnef, n_steps, sample_every, seed)
    return jnef.Simulator(net, seed=seed), p


def _pes(nef, sample_every):
    tab = np.sin(np.linspace(0, 8, 4000, dtype=np.float32))[:, None]
    with nef.Network(seed=0) as net:
        inp = nef.Node(nef.TimeTable(tab, 0.001))
        a = nef.Ensemble(30, 1, neuron_type=nef.LIFRate())
        b = nef.Ensemble(30, 1, neuron_type=nef.LIFRate())
        nef.Connection(inp, a, synapse=None)
        c = nef.Connection(a, b, function=lambda x: x * 0,
                           learning_rule_type=nef.PES(1e-3))
        nef.Connection(inp, c.learning_rule, transform=-1, synapse=0.005)
        p = nef.Probe(c, attr="weights", sample_every=sample_every)
    return net, p


def pes_sim(sample_every=1.0):
    net, p = _pes(pnef, sample_every)
    return pnef.Simulator(net, seed=0, device="cpu"), p


def _sparse_steps(sim, p):
    return sim._sparse_steps[next(bp for bp in sim.model.probes
                                  if bp.obj is p).index]


class TestDenseSubsample:
    def test_rows_match_trange_everywhere(self):
        sim, p = ramp_sim(1200, sample_every=0.01)
        sim.run_steps(1170)
        assert sim.data[p].shape[0] == 117
        assert sim.trange(0.01).shape[0] == 117
        np.testing.assert_allclose(sim.trange(0.01)[-1], 1.17)
        jsim, jp = jax_ramp_sim(1200, sample_every=0.01)
        jsim.run_steps(1170)
        assert_close(sim.data[p], jsim.data[jp])

    def test_chained_runs_keep_global_phase(self):
        sim1, p1 = ramp_sim(400, sample_every=0.005)
        sim1.run_steps(400)
        sim2, p2 = ramp_sim(400, sample_every=0.005)
        for n in (130, 170, 100):
            sim2.run_steps(n)
        np.testing.assert_array_equal(sim1.data[p1], sim2.data[p2])
        jsim, jp = jax_ramp_sim(400, sample_every=0.005)
        for n in (130, 170, 100):
            jsim.run_steps(n)
        assert_close(sim2.data[p2], jsim.data[jp])


class TestSparseProbes:
    def test_chained_unaligned_runs_record_all_samples(self):
        sim, p = pes_sim()
        sim.run_steps(2500)
        sim.run_steps(1500)
        assert sim.data[p].shape[0] == 4
        assert _sparse_steps(sim, p) == [1000, 2000, 3000, 4000]
        jnet, jp = _pes(jnef, 1.0)
        jsim = jnef.Simulator(jnet, seed=0)
        jsim.run_steps(4000)
        assert_close(sim.data[p], jsim.data[jp])

    def test_non_dividing_segment_steps(self):
        sim, p = pes_sim()
        sim.run_steps(4000, segment_steps=700)
        assert sim.data[p].shape[0] == 4

    def test_matches_aligned_reference(self):
        s1, p1 = pes_sim()
        s1.run_steps(3000)
        s2, p2 = pes_sim()
        s2.run_steps(1300)
        s2.run_steps(1700)
        np.testing.assert_array_equal(s1.data[p1], s2.data[p2])


class TestChainedSegments:
    def test_chained_matches_unchained(self):
        n, seg = 900, 200
        sim1, p1 = ramp_sim(n, sample_every=0.007)
        sim1.preload_inputs(n)
        sim1.run_steps(n, segment_steps=seg)
        sim2, p2 = ramp_sim(n, sample_every=0.007)
        sim2.preload_inputs(n)
        sim2.run_steps(n, segment_steps=seg, chain=True)
        np.testing.assert_array_equal(sim2.data[p2], sim1.data[p1])
        assert int(sim2.state["step"]) == int(sim1.state["step"]) == n

    def test_chain_without_table_falls_back(self):
        sim, p = ramp_sim(300)
        sim.run_steps(300, segment_steps=100, chain=True)
        assert sim.data[p].shape[0] == 300


class TestCheckpointSemantics:
    def test_rewind_truncates_probe_buffers(self, tmp_path):
        sim, p = ramp_sim(600)
        sim.run_steps(200)
        ck = str(tmp_path / "ck.npz")
        sim.save_checkpoint(ck)
        sim.run_steps(200)
        branch_a = sim.data[p]
        sim.load_checkpoint(ck)
        assert sim.data[p].shape[0] == 200
        sim.run_steps(200)
        np.testing.assert_array_equal(sim.data[p], branch_a)
        assert sim.data[p].shape[0] == sim.trange().shape[0]

    def test_extensionless_path_roundtrip(self, tmp_path):
        sim, p = ramp_sim(100)
        sim.run_steps(50)
        ck = str(tmp_path / "ck")
        sim.save_checkpoint(ck)
        sim.run_steps(10)
        sim.load_checkpoint(ck)
        assert sim.n_steps == 50 and int(sim.state["step"]) == 50

    def test_rewind_in_checkpoint_born_session(self, tmp_path):
        sim, p = ramp_sim(600)
        sim.run_steps(100)
        ck = str(tmp_path / "ck.npz")
        sim.save_checkpoint(ck)
        sim2, p2 = ramp_sim(600)
        sim2.load_checkpoint(ck)
        assert sim2.data[p2].shape[0] == 0
        sim2.run_steps(50)
        branch_a = sim2.data[p2]
        sim2.load_checkpoint(ck)
        assert sim2.data[p2].shape[0] == 0
        sim2.run_steps(50)
        np.testing.assert_array_equal(sim2.data[p2], branch_a)

    def test_rewind_before_buffer_start_clears(self, tmp_path):
        sim, p = ramp_sim(600)
        sim.run_steps(100)
        early = str(tmp_path / "early.npz")
        sim.save_checkpoint(early)
        sim.run_steps(100)
        late = str(tmp_path / "late.npz")
        sim.save_checkpoint(late)
        sim2, p2 = ramp_sim(600)
        sim2.load_checkpoint(late)
        sim2.run_steps(50)
        assert sim2.data[p2].shape[0] == 50
        sim2.load_checkpoint(early)
        assert sim2.data[p2].shape[0] == 0
        sim2.run_steps(10)
        assert sim2.data[p2].shape[0] == 10

    def test_sparse_rewind(self, tmp_path):
        sim, p = pes_sim()
        sim.run_steps(2000)
        ck = str(tmp_path / "ck.npz")
        sim.save_checkpoint(ck)
        sim.run_steps(2000)
        assert sim.data[p].shape[0] == 4
        sim.load_checkpoint(ck)
        assert sim.data[p].shape[0] == 2

    def test_wrong_model_checkpoint_refused(self, tmp_path):
        sim, _ = pes_sim()
        ck = str(tmp_path / "ck.npz")
        sim.save_checkpoint(ck)
        other, _ = ramp_sim(100)
        with pytest.raises(ValueError, match="leaves|shape"):
            other.load_checkpoint(ck)


def _learning_net(nef):
    """PES + Voja + Alpha filters + a stateful node: every kind of state
    leaf a checkpoint carries."""
    import jax.numpy as jnp

    xp = torch if nef is pnef else jnp

    def latch(t, x, s, consts=None):
        ns = xp.maximum(s, x)
        return ns, ns
    latch.state_init = np.zeros(1, np.float32)
    with nef.Network(seed=3) as net:
        inp = nef.Node(lambda t: np.array([np.sin(5 * t), np.cos(3 * t)]))
        mem = nef.Ensemble(40, 2, neuron_type=nef.LIF(), seed=3)
        c_in = nef.Connection(inp, mem, synapse=None,
                              learning_rule_type=nef.Voja(1e-2))
        out = nef.Node(size_in=2)
        c = nef.Connection(mem, out, function=lambda x: np.zeros(2),
                           learning_rule_type=nef.PES(1e-3), synapse=0.01)
        nef.Connection(out, c.learning_rule, synapse=nef.Alpha(0.01))
        nef.Connection(inp, c.learning_rule, transform=-1, synapse=0.01)
        lt = nef.Node(latch, size_in=1, size_out=1)
        nef.Connection(inp[0], lt, synapse=None)
        p = nef.Probe(out, synapse=0.02)
        nef.Probe(c_in.learning_rule, attr="scaled_encoders")
        nef.Probe(lt)
    return net, p


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_moves_between_packages(tmp_path, direction):
    """A checkpoint written by one package's Simulator loads into the
    other's; both continue 100 steps from it and agree (spiking bounds)."""
    jnet, jp = _learning_net(jnef)
    pnet, pp = _learning_net(pnef)
    jsim = jnef.Simulator(jnet, seed=3)
    psim = pnef.Simulator(pnet, seed=3, device="cpu")
    ck = str(tmp_path / "ck.npz")
    if direction == "jax_to_port":
        jsim.run_steps(150)
        jsim.save_checkpoint(ck)
        psim.load_checkpoint(ck)
        assert int(psim.state["step"]) == 150
    else:
        psim.run_steps(150)
        psim.save_checkpoint(ck)
        jsim.load_checkpoint(ck)
        assert int(np.asarray(jsim.state["step"])) == 150
    assert jsim.n_steps == psim.n_steps == 150
    jsim.run_steps(100)
    psim.run_steps(100)
    assert_close(psim.data[pp][-100:], jsim.data[jp][-100:], spiking=True)
    with np.load(ck) as f:
        assert int(f["n_leaves"]) == len(f.files) - 2


class TestPreloadAndCompile:
    def _pi_net(self, nef, space_cls, pi_cls, seed=0):
        dt, n = 0.001, 300
        ts = dt * np.arange(n)
        path = 0.4 * np.stack([np.sin(2 * np.pi * ts / 0.3),
                               np.cos(2 * np.pi * ts / 0.3)], 1)
        vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
        bounds = 1.2 * np.tile(np.array([-1, 1.0]), (2, 1))
        space = space_cls(2, ssp_dim=31, seed=seed, length_scale=0.3,
                          domain_bounds=bounds)
        scale = 1 / np.max(np.abs(space.phase_matrix @ vels.T))
        init = space.encode(path[:1]).flatten()
        with nef.Network(seed=seed) as net:
            vel = nef.Node(nef.TimeTable(vels * scale, dt))
            ini = nef.Node(lambda t: init if t < 0.05
                           else np.zeros(space.ssp_dim))
            pi = pi_cls(space, 48, 0.05, scaling_factor=scale, stable=True,
                        neuron_type=nef.LIFRate())
            nef.Connection(vel, pi.velocity_input, synapse=None)
            nef.Connection(ini, pi.input, synapse=None)
            p = nef.Probe(pi.output, synapse=0.05)
        return net, p, n

    def port_pi(self):
        from sspslam_tpu_torch import HexagonalSSPSpace
        from sspslam_tpu_torch.models import PathIntegration
        return self._pi_net(pnef, HexagonalSSPSpace, PathIntegration)

    def test_preloaded_matches_streaming_bitwise(self):
        net, p, n = self.port_pi()
        sA = pnef.Simulator(net, seed=0, device="cpu")
        sA.run_steps(n, segment_steps=100)
        netB, pB, _ = self.port_pi()
        sB = pnef.Simulator(netB, seed=0, device="cpu")
        sB.preload_inputs(n)
        sB.run_steps(n, segment_steps=100)
        np.testing.assert_array_equal(sA.data[p], sB.data[pB])
        sB.run_steps(120, segment_steps=60)   # past the horizon: clamped
        assert sB.data[pB].shape[0] == n + 120

    def test_compile_does_not_advance_state(self):
        net, p, n = self.port_pi()
        sA = pnef.Simulator(net, seed=0, device="cpu")
        sA.compile(n, segment_steps=128)
        assert sA.n_steps == 0 and int(sA.state["step"]) == 0
        sA.run_steps(n, segment_steps=128)
        netB, pB, _ = self.port_pi()
        sB = pnef.Simulator(netB, seed=0, device="cpu")
        sB.run_steps(n, segment_steps=128)
        np.testing.assert_array_equal(sA.data[p], sB.data[pB])

    def test_matches_jax_simulator(self):
        from sspslam_tpu import HexagonalSSPSpace
        from sspslam_tpu.models import PathIntegration
        jnet, jp, n = self._pi_net(jnef, HexagonalSSPSpace, PathIntegration)
        jsim = jnef.Simulator(jnet, seed=0)
        jsim.run_steps(n)
        net, p, _ = self.port_pi()
        sim = pnef.Simulator(net, seed=0, device="cpu")
        sim.preload_inputs(n)
        sim.compile(n)
        sim.run_steps(n)
        assert_close(sim.data[p], jsim.data[jp])


class TestSimulatorEdgeCases:
    def _table_net(self, rows, dt=0.001):
        with pnef.Network() as net:
            nd = pnef.Node(pnef.TimeTable(rows, dt))
            p = pnef.Probe(nd)
        return pnef.Simulator(net, device="cpu"), p

    def test_preload_clamp_long_segment(self):
        rows = np.arange(50, dtype=np.float32)[:, None]
        sim, p = self._table_net(rows)
        sim.preload_inputs(50)
        sim.run_steps(2400, segment_steps=1200)
        out = sim.data[p].ravel()
        assert np.array_equal(out[:50], rows.ravel())
        assert np.all(out[50:] == rows[-1, 0])

    def test_streaming_clamp_long_segment(self):
        rows = np.arange(30, dtype=np.float32)[:, None]
        sim, p = self._table_net(rows)
        sim.run_steps(100, segment_steps=100)
        out = sim.data[p].ravel()
        assert np.array_equal(out[:30], rows.ravel())
        assert np.all(out[30:] == rows[-1, 0])

    def test_load_checkpoint_drops_preload(self, tmp_path):
        rows = np.arange(200, dtype=np.float32)[:, None]
        sim, p = self._table_net(rows)
        sim.run_steps(50, segment_steps=50)
        ck = str(tmp_path / "ck.npz")
        sim.save_checkpoint(ck)
        sim2, p2 = self._table_net(rows)
        sim2.preload_inputs(200)
        sim2.run_steps(50, segment_steps=50)
        sim2.load_checkpoint(ck)
        assert sim2._preloaded is None and sim2._preloaded_dev is None
        sim2.run_steps(50, segment_steps=50)
        assert np.array_equal(sim2.data[p2].ravel()[-50:],
                              rows[50:100].ravel())

    def test_device_table_matches_host_path(self):
        rng = np.random.default_rng(0)
        rows = rng.normal(size=(300, 3)).astype(np.float32)

        def build():
            with pnef.Network() as net:
                nd = pnef.Node(pnef.TimeTable(rows, 0.001))
                out = pnef.Node(size_in=3)
                pnef.Connection(nd, out, synapse=0.01)
                p = pnef.Probe(out)
            return pnef.Simulator(net, device="cpu"), p
        sA, pA = build()
        sA.preload_inputs(300, device=False)
        sA.run_steps(300, segment_steps=100)
        sB, pB = build()
        sB.preload_inputs(300, device=True)
        assert sB._preloaded_dev is not None
        sB.run_steps(300, segment_steps=100)
        np.testing.assert_array_equal(sA.data[pA], sB.data[pB])
        sB.run_steps(400, segment_steps=5000)   # past the horizon
        assert np.all(sB.data[pB][-50:] == sB.data[pB][-1])

    def test_table_dt_respected(self):
        """A 10 ms-sampled table driven at 1 ms holds each row 10 steps."""
        tt = pnef.TimeTable(np.arange(20, dtype=np.float32)[:, None], dt=0.01)
        with pnef.Network(seed=0) as net:
            p = pnef.Probe(pnef.Node(tt), synapse=None)
        sim = pnef.Simulator(net, seed=0, dt=0.001, device="cpu")
        sim.run_steps(250)
        expect = np.array([tt((i + 1) * 0.001) for i in range(250)])[:, 0]
        np.testing.assert_array_equal(sim.data[p][:, 0], expect)

    def test_reset_restarts(self):
        sim, p = ramp_sim(300)
        sim.run_steps(120, segment_steps=50)
        first = sim.data[p]
        sim.reset()
        assert sim.n_steps == 0 and sim.data[p].shape[0] == 0
        sim.run_steps(120, segment_steps=40)
        np.testing.assert_array_equal(sim.data[p], first)


def test_simulator_defaults_to_the_card():
    """Without a device argument the Simulator asks for CUDA: on a machine
    with no card it raises and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    net, _ = _ramp(pnef, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pnef.Simulator(net)
