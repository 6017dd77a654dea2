"""The port's batched episodes (sspslam_tpu_torch.parallel) against the JAX
package's run_batched_episodes and against plain runs of each episode.

Tolerances:
- the three-channel oracle of tests/test_parallel.py::TestBatchedEpisodes
  (LIFRate, 200 steps): the port within tests/torch_parity.py's RATE_TOL
  of the JAX package on the same tables, and each channel's mean over the
  last 50 steps within the oracle's 0.06 of its input;
- B = 2 episodes of a small SLAMNetwork (LIF, 200 steps) on the same
  weights: each episode within the spike-flip bounds of the JAX package's
  batched run and of a plain Simulator run of that episode;
- run_seed_sweep: each sim's rows within 1e-5 of that sim run alone (the
  oracle of tests/test_parallel.py::TestSeedSweep).

Every test runs with functorch's vmap fallback warning turned on and
raised as an error: an op without a batching rule would loop over the
episodes.
"""

import warnings

import numpy as np
import pytest
import torch
from torch_parity import RATE_TOL, assert_close, host_params, \
    with_port_hoisted

import sspslam_tpu as jsp
import sspslam_tpu.models as jmodels
import sspslam_tpu.nef as jnef
from sspslam_tpu.parallel import run_batched_episodes as jax_batched

import sspslam_tpu_torch as psp
import sspslam_tpu_torch.models as pmodels
import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.nef.executor import params_from_numpy
from sspslam_tpu_torch.parallel import (BatchedEpisodes,
                                        run_batched_episodes,
                                        run_seed_sweep)

BOUNDS = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
D, N_LM, VIEW_RAD, STEPS = 25, 3, 0.8, 200


FALLBACK = "performance drop"   # functorch's fallback warning text


def assert_no_fallback(err: str):
    """Raise if functorch looped over the batch: its fallback warning
    (issued from C++, so it may reach stderr rather than Python's warnings)
    appears in ``err``."""
    if FALLBACK in err:
        raise AssertionError("an op ran through vmap's fallback loop: "
                             + err[max(0, err.index(FALLBACK) - 200):][:600])


@pytest.fixture(autouse=True)
def no_vmap_fallback(capfd):
    """One torch thread (the small CPU ops contend on more); functorch's
    fallback warning on, raised as an error where it reaches Python's
    warnings and failed on where it reaches stderr."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=f".*{FALLBACK}.*")
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    torch.set_num_threads(n)
    assert_no_fallback(capfd.readouterr().err)


def test_fallback_warning_is_an_error(capfd):
    """The guard catches a batched op that loops: a custom op with no
    batching rule, vmapped."""
    lib = torch.library.Library("sspslam_torch_test", "FRAGMENT")
    lib.define("unbatched(Tensor x) -> Tensor")
    lib.impl("unbatched", lambda x: x * 2, "CPU")
    with pytest.raises((UserWarning, AssertionError), match=FALLBACK):
        torch.func.vmap(torch.ops.sspslam_torch_test.unbatched)(
            torch.ones(3, 2))
        assert_no_fallback(capfd.readouterr().err)


def _three_channels(nef):
    with nef.Network(seed=1) as net:
        inp = nef.Node(lambda t: np.zeros(1))
        ens = nef.Ensemble(150, 1, neuron_type=nef.LIFRate(), seed=1)
        out = nef.Node(size_in=1)
        nef.Connection(inp, ens, synapse=None)
        nef.Connection(ens, out, synapse=0.02)
        p = nef.Probe(out)
    return net, p


def test_three_channels_match_jax():
    vals = np.array([[0.5], [-0.3], [0.1]])
    n_steps = 200
    tables = [np.tile(vals[:, None, :], (1, n_steps, 1))]
    jnet, jp = _three_channels(jnef)
    pnet, pp = _three_channels(pnef)
    want, _ = jax_batched(jnef.Simulator(jnet, seed=1), tables, n_steps)
    sim = pnef.Simulator(pnet, seed=1, device="cpu")
    got, final = run_batched_episodes(sim, tables, n_steps)
    assert got[pp].shape == (3, n_steps, 1)
    assert_close(got[pp], np.asarray(want[jp]))
    assert np.allclose(got[pp][:, -50:].mean(axis=1), vals, atol=0.06)
    assert final["step"].tolist() == [n_steps] * 3
    assert int(sim.state["step"]) == 0 and sim.n_steps == 0


def _slam(sp, models, nef, tables):
    """A small SLAMNetwork whose five inputs are TimeTables of ``tables``
    (velocity, initial clamp, landmark SP, landmark vector SSP, in-view),
    in the JAX scaled CLI's layout; returns (network, PI probe)."""
    space = _space(sp)
    lm_space = sp.SPSpace(N_LM, D, seed=0)
    with nef.Network(seed=0) as net:
        nodes = [nef.Node(nef.TimeTable(t, 0.001)) for t in tables[:5]]
        slam = models.SLAMNetwork(
            space, lm_space, VIEW_RAD, N_LM, pi_n_neurons=80,
            mem_n_neurons=90, circonv_n_neurons=30,
            vel_scaling_factor=tables[5], cleanup_samples_per_dim=30,
            seed=0, update_thres=0.2)
        for node, dst in zip(nodes, (slam.velocity_input,
                                     slam.pathintegrator.input,
                                     slam.landmark_id_input,
                                     slam.landmark_vec_ssp,
                                     slam.no_landmark_in_view)):
            nef.Connection(node, dst, synapse=None)
        p = nef.Probe(slam.output, synapse=0.05)
    return net, p


def _space(sp):
    return sp.HexagonalSSPSpace(2, ssp_dim=D, seed=0, length_scale=0.3,
                                domain_bounds=BOUNDS)


def _episodes(B):
    """B episodes' input tables (velocity, clamp, landmark SP, landmark
    vector SSP, in-view, then the velocity scale): a looping path started at
    phase b/B, each with its own N_LM landmarks; and the shared scale."""
    space = _space(psp)
    lm_space = psp.SPSpace(N_LM, D, seed=0)
    dt = 0.001
    out = []
    for b in range(B):
        ts = dt * np.arange(STEPS) + 0.6 * b / B
        path = 0.6 * np.stack([np.sin(2 * np.pi * ts / 0.6),
                               np.cos(2 * np.pi * ts / 0.6)], 1)
        vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
        lms = np.random.default_rng(b).uniform(-0.7, 0.7, (N_LM, 2))
        (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
            pmodels.get_slam_input_functions(space, lm_space, vels,
                                             lms[None] - path[:, None],
                                             VIEW_RAD)
        init = pnef.clamp_table(space.encode(path[:1]).ravel(), 0.05)
        out.append([f.rows(0, STEPS) for f in
                    (vel_f, init, sp_f, vecssp_f, in_view_f)] + [scale])
    # the velocity scale is baked into the model, so every episode's
    # velocities are rescaled to the smallest (as the scaled CLI does)
    scale = min(ep[5] for ep in out)
    for ep in out:
        ep[0] = (ep[0] / ep[5] * scale).astype(np.float32)
    return out, scale


def test_batched_slam_matches_jax_and_plain_runs(monkeypatch):
    """B = 2: both packages' batched runs on the same weights and tables,
    and each port episode against a plain port run of it, within the
    spike-flip bounds."""
    for name in ("SSPSLAM_HOIST_CLEANUP", "SSPSLAM_HOIST_GATE",
                 "SSPSLAM_CLEANUP_F32"):
        monkeypatch.setenv(name, "1")
    eps, scale = _episodes(2)
    tables0 = eps[0][:5] + [scale]
    jnet, jp = _slam(jsp, jmodels, jnef, tables0)
    pnet, pp = _slam(psp, pmodels, pnef, tables0)
    jsim = jnef.Simulator(jnet, seed=0)
    psim = pnef.Simulator(pnet, seed=0, device="cpu")
    psim.params = params_from_numpy(
        psim.model, with_port_hoisted(psim.model, host_params(jsim.params)),
        device="cpu")
    batched = [np.stack([ep[i] for ep in eps]) for i in range(5)]
    want, _ = jax_batched(jsim, batched, STEPS)
    got, _ = run_batched_episodes(psim, batched, STEPS)
    assert got[pp].shape == (2, STEPS, D)
    for b in range(2):
        assert_close(got[pp][b], np.asarray(want[jp])[b], spiking=True,
                     what=f"episode {b} vs JAX")
        net, p = _slam(psp, pmodels, pnef, eps[b][:5] + [scale])
        plain = pnef.Simulator(net, seed=0, device="cpu")
        plain.params = psim.params
        plain.run_steps(STEPS)
        assert_close(got[pp][b], plain.data[p], spiking=True,
                     what=f"episode {b} vs its plain run")
    assert not np.allclose(got[pp][0], got[pp][1], atol=1e-2)


def test_batched_segments_continue_the_run():
    """BatchedEpisodes.run in segments reads the table on from where it
    stopped: two segments equal one run of their length (eager on the
    CPU, so bitwise); without collection no probe buffer is made."""
    pnet, pp = _three_channels(pnef)
    sim = pnef.Simulator(pnet, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.uniform(-0.5, 0.5, (120, 2, 1)),
                            dtype=torch.float32)
    whole = BatchedEpisodes(sim, [table]).run(120)
    split = BatchedEpisodes(sim, [table])
    first = split.run(50)[0].clone()
    second = split.run(70)[0]
    assert torch.equal(torch.cat([first, second]), whole[0])
    assert BatchedEpisodes(sim, [table], collect=False).run(10) is None
    with pytest.raises(ValueError, match="input tables"):
        BatchedEpisodes(sim, [])


def _pi(nef, seed):
    space = _space(psp if nef is pnef else jsp)
    ssp0 = space.encode(np.array([[0.1, -0.2]])).flatten()
    models = pmodels if nef is pnef else jmodels
    with nef.Network(seed=seed) as net:
        vel = nef.Node(lambda t: np.array([0.1, 0.0]))
        init = nef.Node(lambda t: ssp0 if t < 0.05 else np.zeros(D))
        pi = models.PathIntegration(space, 40, 0.05,
                                    neuron_type=nef.LIFRate())
        nef.Connection(vel, pi.velocity_input, synapse=None)
        nef.Connection(init, pi.input, synapse=None)
        p = nef.Probe(pi.output, synapse=0.05)
    return net, p


def test_seed_sweep_matches_runs_alone():
    """Three seeds swept in turn: each sim's rows equal its run alone (the
    oracle's 1e-5), and the seeds differ."""
    sims, probes = [], []
    for seed in (0, 1, 2):
        net, p = _pi(pnef, seed)
        sims.append(pnef.Simulator(net, seed=seed, device="cpu"))
        probes.append(p)
    sims[0].run_steps(10)   # a sim with rows already kept
    results = run_seed_sweep(sims, 80, segment_steps=40)
    for seed, p in zip((0, 1, 2), probes):
        net, p2 = _pi(pnef, seed)
        solo = pnef.Simulator(net, seed=seed, device="cpu")
        solo.run_steps(90 if seed == 0 else 80, segment_steps=40)
        want = solo.data[p2][-80:]
        assert results[seed][p].shape == want.shape
        assert np.abs(results[seed][p] - want).max() <= 1e-5
    assert not np.allclose(results[0][probes[0]], results[1][probes[1]],
                           atol=1e-3)
    assert RATE_TOL <= 1e-4
