"""The port's ClosedLoopSession and closed_loop_nav CLI against the JAX
package's, on the CPU (where a tick steps eagerly).

Each network is built by both packages from one seed and the port's
Simulator is given the JAX parameters (``params_from_numpy``), so tick
outputs are compared with the JAX session's within the rate-network bound
of ``tests/torch_parity.py`` (1e-4 relative); the session's own semantics
(ticks against an uninterrupted run, zero-order hold, record) are held
exactly.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import sspslam_tpu.nef as jnef
import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.nef.executor import params_from_numpy

from torch_parity import assert_close, host_params, with_port_hoisted

REPO = Path(__file__).resolve().parents[1]


def _net(nef, n_steps, with_tabulated=False, dt=0.001):
    """One live input driving an ensemble; optionally a second, tabulated
    input node summed in (mixed live / tabulated ticks)."""
    tab = np.sin(np.linspace(0, 6, n_steps, dtype=np.float32))[:, None]
    with nef.Network(seed=0) as net:
        live = nef.Node(lambda t: np.zeros(1))   # driven live
        ens = nef.Ensemble(50, 1, neuron_type=nef.LIFRate())
        nef.Connection(live, ens, synapse=None)
        if with_tabulated:
            nef.Connection(nef.Node(nef.TimeTable(0.3 * tab, dt)), ens,
                           synapse=None)
        p = nef.Probe(ens, synapse=0.01)
    return net, live, p


def _pair(make):
    """(JAX simulator, port simulator with the JAX params, JAX objects,
    port objects) of ``make(nef) -> (net, *objects)``."""
    jnet, *jobj = make(jnef)
    pnet, *pobj = make(pnef)
    jsim = jnef.Simulator(jnet, seed=0)
    psim = pnef.Simulator(pnet, seed=0, device="cpu")
    psim.params = params_from_numpy(
        psim.model, with_port_hoisted(psim.model, host_params(jsim.params)),
        device="cpu")
    return jsim, psim, jobj, pobj


def test_ticks_match_uninterrupted_run_and_jax():
    """Ticks fed per-step rows equal one open-loop run of the same rows
    through a TimeTable node (exactly), and the JAX session's ticks."""
    n, seg = 200, 20
    rows = np.cos(np.linspace(0, 4, n, dtype=np.float32))[:, None]
    with pnef.Network(seed=0) as net_a:
        inp = pnef.Node(pnef.TimeTable(rows, 0.001))
        ens = pnef.Ensemble(50, 1, neuron_type=pnef.LIFRate())
        pnef.Connection(inp, ens, synapse=None)
        pa = pnef.Probe(ens, synapse=0.01)
    sim_a = pnef.Simulator(net_a, seed=0, device="cpu")
    sim_a.run_steps(n, segment_steps=seg)
    net_b, live, pb = _net(pnef, n)
    sim_b = pnef.Simulator(net_b, seed=0, device="cpu")
    sess = pnef.ClosedLoopSession(sim_b, live_inputs=[live], outputs=[pb],
                                  tick_steps=seg)
    got = np.concatenate([sess.tick({live: rows[i:i + seg]})[pb]
                          for i in range(0, n, seg)])
    np.testing.assert_array_equal(sim_a.data[pa], got)
    assert sim_b.n_steps == n

    jsim, psim, (jlive, jp), (plive, pp) = _pair(lambda nef: _net(nef, n))
    out = {}
    for side, sim, live, p, cls in (
            ("jax", jsim, jlive, jp, jnef.ClosedLoopSession),
            ("port", psim, plive, pp, pnef.ClosedLoopSession)):
        s = cls(sim, live_inputs=[live], outputs=[p], tick_steps=seg)
        out[side] = np.concatenate([s.tick({live: rows[i:i + seg]})[p]
                                    for i in range(0, n, seg)])
    assert_close(out["port"], out["jax"], what="ticks")


def test_zero_order_hold_matches_repeated_rows():
    outs = []
    for value in (np.array([0.5]), np.full((10, 1), 0.5, np.float32)):
        net, live, p = _net(pnef, 100)
        sim = pnef.Simulator(net, seed=0, device="cpu")
        sess = pnef.ClosedLoopSession(sim, live_inputs=[live],
                                      tick_steps=10)
        outs.append(sess.tick({live: value})[p])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_mixed_live_and_tabulated_and_warmup_match_jax():
    """A tabulated node keeps its rows, aligned to the global step counter
    across an open-loop warm-up (preloaded inputs, which a tick drops) and
    the ticks after it; outputs as the JAX session's, n_steps and t
    advanced."""
    n, seg = 120, 30
    jsim, psim, (jlive, jp), (plive, pp) = _pair(
        lambda nef: _net(nef, n, with_tabulated=True))
    out = {}
    for side, sim, live, p, cls in (
            ("jax", jsim, jlive, jp, jnef.ClosedLoopSession),
            ("port", psim, plive, pp, pnef.ClosedLoopSession)):
        sim.preload_inputs(seg, device=False)
        sim.run_steps(seg)
        s = cls(sim, live_inputs=[live], outputs=[p], tick_steps=seg)
        ticks = [s.tick({live: np.full(1, 0.1 * i, np.float32)})[p]
                 for i in range(3)]
        out[side] = np.concatenate([sim.data[p]] + ticks)
        assert sim.n_steps == n and sim._preloaded is None
        np.testing.assert_allclose(s.t, 0.120)
    assert out["port"].shape == (n, 1)
    assert_close(out["port"], out["jax"], what="warm-up then ticks")


def test_record_populates_sim_data():
    net, live, p = _net(pnef, 100)
    sim = pnef.Simulator(net, seed=0, device="cpu")
    sess = pnef.ClosedLoopSession(sim, live_inputs=[live], outputs=[p],
                                  tick_steps=10, record=True)
    outs = [sess.tick({live: np.array([0.2])})[p] for _ in range(3)]
    np.testing.assert_array_equal(sim.data[p], np.concatenate(outs))
    assert sim.trange().shape[0] == 30
    # the returned rows are copies: later ticks do not change them
    first = outs[0].copy()
    sess.tick({live: np.array([-0.9])})
    np.testing.assert_array_equal(outs[0], first)


def test_bad_inputs_raise():
    net, live, p = _net(pnef, 50)
    sim = pnef.Simulator(net, seed=0, device="cpu")
    sess = pnef.ClosedLoopSession(sim, live_inputs=[live], tick_steps=10)
    with pytest.raises(ValueError, match="missing"):
        sess.tick({})
    with pytest.raises(ValueError, match="expected shape"):
        sess.tick({live: np.zeros((7, 1), np.float32)})
    with pytest.raises(ValueError, match="tick_steps"):
        pnef.ClosedLoopSession(sim, tick_steps=0)
    other, stray, p2 = _net(pnef, 10)
    with pytest.raises(ValueError, match="not an input node"):
        pnef.ClosedLoopSession(sim, live_inputs=[stray])
    with pytest.raises(ValueError, match="not a probe"):
        pnef.ClosedLoopSession(sim, outputs=[p2])
    tab_net, tab_live, _ = _net(pnef, 50, with_tabulated=True)
    tab_sim = pnef.Simulator(tab_net, seed=0, device="cpu")
    tab_sess = pnef.ClosedLoopSession(tab_sim, live_inputs=[tab_live],
                                      tick_steps=10)
    tabulated = tab_sim.model.input_nodes[1]
    with pytest.raises(ValueError, match="not declared in live_inputs"):
        tab_sess.tick({tab_live: np.zeros(1), tabulated: np.zeros(1)})


def _pes_net(nef, period, live_input=True):
    with nef.Network(seed=0) as net:
        inp = nef.Node(lambda t: np.array([0.3]))
        live = nef.Node(lambda t: np.zeros(1))
        a = nef.Ensemble(30, 1, neuron_type=nef.LIFRate())
        b = nef.Ensemble(30, 1, neuron_type=nef.LIFRate())
        nef.Connection(inp, a, synapse=None)
        if live_input:
            nef.Connection(live, a, synapse=None)
        c = nef.Connection(a, b, function=lambda x: x * 0,
                           learning_rule_type=nef.PES(1e-3))
        nef.Connection(inp, c.learning_rule, transform=-1, synapse=0.005)
        pw = nef.Probe(c, attr="weights", sample_every=period)
        pd = nef.Probe(b, synapse=0.01)
    return net, live, pw, pd


def test_sparse_probe_snapshots_when_tick_crosses_period():
    """Ticks of 30 steps against a 50-step weights period: a snapshot at
    each tick boundary that crossed a period boundary, with its true step
    (60, 120), the weights the JAX session snapshots there; a sparse probe
    cannot be a tick output.  Ticks of 25 steps end on the period's steps,
    as run_steps' segments do: their snapshots are run_steps' (steps 50,
    100, the same weights)."""
    jsim, psim, (jlive, jpw, jpd), (plive, ppw, ppd) = _pair(
        lambda nef: _pes_net(nef, 0.05))
    for sim, live, pd, cls in ((jsim, jlive, jpd, jnef.ClosedLoopSession),
                               (psim, plive, ppd, pnef.ClosedLoopSession)):
        s = cls(sim, live_inputs=[live], outputs=[pd], tick_steps=30)
        for _ in range(4):     # 120 steps; period boundaries at 50, 100
            s.tick({live: np.zeros(1, np.float32)})
    w = psim.data[ppw]
    assert w.shape[0] == 2
    bp = next(p for p in psim.model.probes if p.obj is ppw)
    assert psim._sparse_steps[bp.index] == [60, 120]
    assert_close(w, jsim.data[jpw], what="weights snapshots")
    with pytest.raises(ValueError, match="sparse"):
        pnef.ClosedLoopSession(psim, outputs=[ppw])

    psim.reset()
    s = pnef.ClosedLoopSession(psim, live_inputs=[plive], outputs=[ppd],
                               tick_steps=25)
    for _ in range(4):
        s.tick({plive: np.zeros(1, np.float32)})
    _, run_sim, _, (_, run_pw, _) = _pair(lambda nef: _pes_net(nef, 0.05))
    run_sim.run_steps(100)
    run_bp = next(p for p in run_sim.model.probes if p.obj is run_pw)
    assert psim._sparse_steps[bp.index] == [50, 100]
    assert run_sim._sparse_steps[run_bp.index] == [50, 100]
    np.testing.assert_array_equal(psim.data[ppw], run_sim.data[run_pw])


def test_warns_when_sparse_period_shorter_than_tick():
    net, *_ = _pes_net(pnef, 0.01, live_input=False)   # period 10
    sim = pnef.Simulator(net, seed=0, device="cpu")
    with pytest.warns(UserWarning, match="sparse probe"):
        pnef.ClosedLoopSession(sim, live_inputs=[], tick_steps=50)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pnef.ClosedLoopSession(sim, live_inputs=[], tick_steps=10)


def test_compile_does_not_advance():
    net, live, p = _net(pnef, 100)
    sim = pnef.Simulator(net, seed=0, device="cpu")
    sim.preload_inputs(100)
    sess = pnef.ClosedLoopSession(sim, live_inputs=[live], outputs=[p],
                                  tick_steps=13)
    sess.compile()
    assert sim.n_steps == 0 and int(sim.state["step"]) == 0
    assert sess.tick({live: np.array([0.1])})[p].shape == (13, 1)


NAV_ARGS = ("--ssp-dim", "13", "--pi-n-neurons", "40", "--mem-n-neurons",
            "60", "--circonv-n-neurons", "10", "--n-landmarks", "4",
            "--explore-T", "0.3", "--nav-T", "0.3", "--decode-grid", "21")


def test_closed_loop_nav_matches_jax():
    """closed_loop_nav at a tiny width on the CPU: the JAX CLI as a child,
    the port's main in this process; the same JSON keys and the same
    navigation outcome (distances and estimate errors to the printed 4
    decimals; the latencies are this host's)."""
    import contextlib
    import io
    from sspslam_tpu_torch.experiments import closed_loop_nav
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               SSPSLAM_CLEANUP_F32="1", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "experiments" / "closed_loop_nav.py"),
         "--cpu", *NAV_ARGS], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    os.environ["SSPSLAM_CLEANUP_F32"] = "1"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the port's small ops: one thread is fastest
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            closed_loop_nav.main(["--device", "cpu", *NAV_ARGS])
    finally:
        del os.environ["SSPSLAM_CLEANUP_F32"]
        torch.set_num_threads(threads)
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    port = json.loads(out.getvalue().strip().splitlines()[-1])
    ref = json.loads(stdout.strip().splitlines()[-1])
    assert sorted(port) == sorted(ref)
    for key in ("metric", "final_dist", "min_dist", "reached_0p15",
                "explore_est_err_median", "nav_est_err_median",
                "tick_steps", "n_ticks"):
        assert port[key] == ref[key], key
    assert port["tick_latency_ms_median"] > 0
