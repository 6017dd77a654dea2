"""The path-integrator variants and the gated working memory on the CPU
against the JAX package: PathIntegrationReencode, PathIntegrationGC (with
and without coupling), PathIntegrationBCsGCs and AdditiveInputGatedMemory.

For each: the built parameters equal the JAX package's bitwise (the port
also hoists Reencode's sample bank, which the JAX package keeps in a
closure; that table is checked against the space's own bank), then both
executors step the same weights (tests/torch_parity.py: rate neurons
within 1e-4 of max(|probe|, 1), LIF within the spike-flip bounds).  The
clean-up of Reencode fires on the same steps in both packages (float32
argmax, SSPSLAM_CLEANUP_F32=1 on both sides); the memory holds its value
when the gate closes and clears on reset, as tests/test_workingmemory.py
asserts of the JAX package.
"""

import numpy as np
import pytest
import torch
from torch_parity import (assert_runs_match, host_params, leaves,
                          with_port_hoisted)

import sspslam_tpu as jsp
import sspslam_tpu.models as jmodels
import sspslam_tpu.nef as jnef
from sspslam_tpu.nef import Simulator as JaxSimulator

import sspslam_tpu_torch as psp
import sspslam_tpu_torch.models as pmodels
import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.nef.builder import build as port_build
from sspslam_tpu_torch.nef.executor import build_params, params_from_numpy

PACKAGES = ((jsp, jmodels, jnef), (psp, pmodels, pnef))
D, STEPS = 25, 300


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space(sp):
    return sp.HexagonalSSPSpace(2, ssp_dim=D, seed=0, length_scale=0.3,
                                domain_bounds=1.1 * np.tile([-1, 1.0],
                                                            (2, 1)))


def _pi_net(sp, models, nef, variant, spiking=False):
    """``variant`` on a turning path from an initial SSP, LIFRate (or LIF);
    returns (network, {probe name: probe})."""
    space = _space(sp)
    dt = 0.001
    ts = dt * np.arange(STEPS)
    vels = 0.3 * np.stack([np.cos(6 * ts), np.sin(4 * ts)], 1)
    scale = 1.0 / np.max(np.abs(space.phase_matrix @ vels.T))
    neuron = nef.LIF() if spiking else nef.LIFRate()
    with nef.Network(seed=0) as net:
        if variant == "reencode":
            pi = models.PathIntegrationReencode(
                space, 80, 0.05, scaling_factor=scale, cleanup_dt=0.05,
                cleanup_samples_per_dim=30, neuron_type=neuron)
        elif variant.startswith("gc"):
            pi = models.PathIntegrationGC(
                space, 120, 0.05, scaling_factor=scale,
                coupling=variant == "gc-coupled", coupling_factor=0.1,
                neuron_type=neuron)
        else:
            pi = models.PathIntegrationBCsGCs(space, 80, 60, 0.05,
                                              scaling_factor=scale,
                                              neuron_type=neuron)
        nef.Connection(nef.Node(nef.TimeTable(vels * scale)),
                       pi.velocity_input, synapse=None)
        nef.Connection(nef.Node(nef.clamp_table(
            space.encode([[0.15, -0.2]])[0], 0.05)), pi.input, synapse=None)
        probes = {"out": nef.Probe(pi.output, synapse=0.05)}
        if variant == "reencode":
            cleanup = next(n for n in net.all_objects()[1]
                           if n.label == "pathint_cleanup")
            probes["cleanup"] = nef.Probe(cleanup)
    return net, probes


def _memory_net(sp, models, nef, reset_at=None, seed=0):
    """tests/test_workingmemory.py's network: load 0.6, close the gate at
    0.3 s, flip the input; with ``reset_at`` the reset opens then."""
    with nef.Network(seed=seed) as net:
        stim = nef.Node(lambda t: np.array([0.6 if t < 0.3 else -0.8]))
        inp = nef.Ensemble(150, 1, neuron_type=nef.LIFRate(), seed=seed)
        nef.Connection(stim, inp, synapse=None)
        wm = models.AdditiveInputGatedMemory(inp, inp, 150, 1, gain=0.3,
                                             recurrent_synapse=0.1,
                                             neuron_type=nef.LIFRate())
        nef.Connection(nef.Node(lambda t: np.array(
            [0.0 if t < 0.3 else 3.0])), wm.gate, synapse=None)
        r = 1e9 if reset_at is None else reset_at
        nef.Connection(nef.Node(lambda t: np.array(
            [0.0 if t < r else 3.0])), wm.reset, synapse=None)
        probes = {"out": nef.Probe(wm.output, synapse=0.05)}
    return net, probes


VARIANTS = ["reencode", "gc", "gc-coupled", "bcsgcs"]


def _build(variant):
    make = _memory_net if variant == "memory" else (
        lambda *pk: _pi_net(*pk, variant))
    return [make(*pk) for pk in PACKAGES]


@pytest.mark.parametrize("variant", VARIANTS + ["memory"])
def test_build_params_equal_jax(variant):
    (jnet, _), (pnet, _) = _build(variant)
    jsim = JaxSimulator(jnet, seed=0)
    model = port_build(pnet, seed=0, device="cpu")
    own = build_params(model, device="cpu")
    given = params_from_numpy(
        model, with_port_hoisted(model, host_params(jsim.params)),
        device="cpu")
    assert len(leaves(own)) == len(leaves(given)) > 0
    for a, b in zip(leaves(own), leaves(given)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool(jsim.params["hoisted"]) is False
    if variant == "reencode":
        # the one port-only table: the space's bank, float32 both ways
        (tables,) = own["hoisted"].values()
        bank = np.asarray(_space(psp).get_sample_pts_and_ssps(30)[0],
                          np.float32)
        np.testing.assert_array_equal(tables["bank"].numpy(), bank)
        np.testing.assert_array_equal(tables["bank_sim"].numpy(), bank)
    else:
        assert own["hoisted"] == {}


@pytest.mark.parametrize("variant", VARIANTS)
def test_pi_variant_runs_match_jax(variant):
    (jnet, jp), (pnet, pp) = _build(variant)
    # BCsGCs' grid cells are LIF whatever the oscillators' neuron type
    jout, pout, *_ = assert_runs_match(jnet, pnet, STEPS, seed=0,
                                       spiking=variant == "bcsgcs")
    out = pout[0]
    assert np.abs(out[-1]).max() > 0.05
    if variant == "reencode":
        fired = [np.flatnonzero(np.abs(o[1]).max(axis=1) > 0)
                 for o in (jout, pout)]
        np.testing.assert_array_equal(fired[1], fired[0])
        # t mod 0.05 < 0.01 fires on 10 of every 50 steps
        assert 50 <= len(fired[1]) <= 70, len(fired[1])


def test_reencode_spiking_runs_match_jax():
    (jnet, _), (pnet, _) = [_pi_net(*pk, "reencode", spiking=True)
                            for pk in PACKAGES]
    assert_runs_match(jnet, pnet, STEPS, seed=0, spiking=True)


def test_memory_runs_match_jax():
    (jnet, _), (pnet, _) = _build("memory")
    assert_runs_match(jnet, pnet, STEPS, seed=0)


@pytest.mark.parametrize("reset", [False, True], ids=["gate-holds",
                                                      "reset-clears"])
def test_memory_gate_and_reset(reset):
    """tests/test_workingmemory.py's assertions, on the port's Simulator."""
    seed = 1 if reset else 0
    net, probes = _memory_net(psp, pmodels, pnef,
                              reset_at=0.5 if reset else None, seed=seed)
    sim = pnef.Simulator(net, seed=seed, device="cpu",
                         default_neuron_type=pnef.LIFRate())
    sim.run(0.9 if reset else 1.0)
    y = sim.data[probes["out"]][:, 0]
    if reset:
        assert y[450] > 0.15          # held before reset
        assert abs(y[-1]) < 0.1       # cleared after reset
    else:
        assert y[300] > 0.2
        assert abs(y[-1] - y[300]) < 0.25
        assert y[-1] > -0.1
