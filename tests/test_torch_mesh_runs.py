"""The port's other multi-rank paths on gloo ranks on the CPU against the
JAX package's mesh runs on the conftest's virtual CPU devices.

- The anchored SLAM with LIF neurons at world 2: the PI output within
  tests/torch_parity.py's spike-flip bounds of the JAX mesh run and of
  the port's unsharded run.
- int8 storage at world 4 (tests/test_parallel.py's sharded-int8 case):
  within 5e-4 of the port's unsharded int8 run and of the JAX package's
  int8 mesh run.
- dp x tp episodes on a (2, 2) ("data", "model") mesh: every episode
  within 2e-4 (test_parallel.py's dp x tp bound) of the JAX package's
  run on a (2, 2) mesh, and of the port's unsharded batched run.
- ``fit`` on a data mesh of 2 (test_train.py's data-parallel fit, 8
  episodes, Adam 5e-3, 60 steps): the losses within rtol 1e-4, atol 1e-6
  of the port's unsharded fit (test_train.py's bound) and of the JAX
  package's ``fit(mesh=...)``; the trained decoders likewise; the same
  on both ranks.
- The sharded VCO scan at world 2 and 4, two chunks: within 2e-4 of the
  JAX package's ``shard_map`` scan (test_parallel.py's bound), one shard
  (one kernel call a chunk) a rank.
- A fused k = 4 group split over its elements at world 2 and 4 (a
  grouped decode, a neuron-level read, single-element probes): within
  5e-4 of the port unsharded and of the JAX mesh run.
"""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from torch_parity import assert_close, spawn_ranks

import jax.numpy as jnp
import optax
from sspslam_tpu import train as jtrain
from sspslam_tpu.models.fast_pathint import (
    FastPathIntegrator as JaxFastPathIntegrator)
from sspslam_tpu.nef import Simulator as JaxSimulator
from sspslam_tpu.parallel import make_mesh as jax_make_mesh
from sspslam_tpu.parallel import run_batched_episodes as jax_batched
from sspslam_tpu.parallel import shard_step as jax_shard_step

from sspslam_tpu_torch import train as ptrain
from sspslam_tpu_torch.ops import vco_scan as vs
from sspslam_tpu_torch.parallel import run_batched_episodes

JAX = R.lib("sspslam_tpu")
MESH_TOL = 5e-4
DPTP_TOL = 2e-4
VCO_TOL = 2e-4
FIT_RTOL, FIT_ATOL = 1e-4, 1e-6
SLAM_STEPS, INT8_STEPS, EP_STEPS, FIT_N, FIT_B, FIT_STEPS = \
    200, 100, 60, 100, 8, 60
FUSED_STEPS = 100
VCO_T = 30


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vco_case():
    """tests/test_parallel.py's sharded-scan set-up, two chunks: its
    space, 40 neurons a VCO, a correction at step 0."""
    space = R.space(JAX)
    fpi = JaxFastPathIntegrator(space, 40, seed=0, interpret=True,
                                mxu_decode=False)
    rng = np.random.default_rng(0)
    vels = (0.03 * rng.normal(size=(2 * VCO_T, 2))).astype(np.float32)
    corr = np.zeros((2 * VCO_T, space.ssp_dim), np.float32)
    corr[0] = space.encode(np.array([[0.1, -0.1]])).flatten()
    arrays = {f: np.asarray(getattr(fpi.params, f))
              for f in vs.ARRAY_FIELDS}
    consts = {f: getattr(fpi.params, f) for f in vs.CONST_FIELDS}
    return fpi, arrays, consts, vels, corr


@pytest.fixture(scope="module")
def vco():
    return vco_case()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, vco):
    """One spawn of 2 ranks (the LIF SLAM, the VCO scan, the fit, the
    fused group) and one of 4 (int8, the VCO scan, dp x tp episodes, the
    fused group)."""
    _, arrays, consts, vels, corr = vco
    tmp = tmp_path_factory.mktemp("mesh_runs")
    two = spawn_ranks(R.run_jobs, 2, tmp, args=([
        ("run_sharded", ("slam", {}, SLAM_STEPS, {"spiking": True})),
        ("run_vco", (arrays, consts, vels, corr)),
        ("run_fit", (FIT_N, FIT_B, FIT_STEPS)),
        ("run_sharded", ("fused", {}, FUSED_STEPS, {}))],))
    four = spawn_ranks(R.run_jobs, 4, tmp, args=([
        ("run_sharded", ("int8", {}, INT8_STEPS,
                         {"matmul_dtype": "int8"})),
        ("run_vco", (arrays, consts, vels, corr)),
        ("run_episodes", ("pi", {}, EP_STEPS, (2, 2))),
        ("run_sharded", ("fused", {}, FUSED_STEPS, {}))],))
    return {2: two, 4: four}


def test_lif_slam_within_spike_flip_bounds(ranks):
    got = ranks[2][0][0]["traces"][0]
    assert np.array_equal(got, ranks[2][1][0]["traces"][0])
    net, probes = R.NETS["slam"](JAX)
    jsim = JaxSimulator(net, seed=0, mesh=jax_make_mesh(2))
    jsim.run_steps(SLAM_STEPS)
    assert_close(got, np.asarray(jsim.data[probes[0]]), spiking=True,
                 what="sharded LIF SLAM vs the JAX mesh run")
    sim, pprobes = R.build_sim("slam", {}, spiking=True)
    sim.run_steps(SLAM_STEPS)
    assert_close(got, sim.data[pprobes[0]], spiking=True,
                 what="sharded LIF SLAM vs unsharded")


def test_int8_sharded_matches_unsharded_and_jax(ranks):
    got = ranks[4][0][0]["traces"][0]
    sim, probes = R.build_sim("int8", {}, matmul_dtype="int8")
    sim.run_steps(INT8_STEPS)
    want = sim.data[probes[0]]
    net, jprobes = R.NETS["int8"](JAX)
    jsim = JaxSimulator(net, seed=0, mesh=jax_make_mesh(4),
                        matmul_dtype="int8")
    jsim.run_steps(INT8_STEPS)
    for ref in (want, np.asarray(jsim.data[jprobes[0]])):
        assert got.shape == ref.shape and np.all(np.isfinite(got))
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(got - ref).max() <= MESH_TOL * scale


def test_dp_tp_episodes_match_jax_mesh(ranks):
    got = ranks[4][0][2][0]
    for res in ranks[4][1:]:
        assert np.array_equal(res[2][0], got)
    net, probes = R.NETS["pi"](JAX)
    jsim = JaxSimulator(net, seed=0)
    tables = R.episode_tables(jsim, EP_STEPS, 2)
    mesh = jax_make_mesh(4, axis_names=("data", "model"), shape=(2, 2))
    want = np.asarray(jax_batched(jsim, tables, EP_STEPS,
                                  mesh=mesh)[0][probes[0]])
    sim, pprobes = R.build_sim("pi", {})
    plain = run_batched_episodes(sim, R.episode_tables(sim, EP_STEPS, 2),
                                 EP_STEPS)[0][pprobes[0]]
    assert got.shape == want.shape == plain.shape == (2, EP_STEPS,
                                                      got.shape[-1])
    assert not np.allclose(got[0], got[1])      # the episodes differ
    assert np.abs(got - want).max() <= DPTP_TOL
    assert np.abs(got - plain).max() <= DPTP_TOL


def test_fit_on_data_mesh_matches_jax_and_unsharded(ranks):
    losses, D = ranks[2][0][2]
    assert ranks[2][1][2][0] == losses
    assert np.array_equal(ranks[2][1][2][1], D)
    # the port unsharded, same problem
    sim, pi, xs_b, loss_fn, path = R.fit_problem(FIT_N, FIT_B)
    bep = ptrain.make_batched_episode_fn(sim, FIT_N, segment_steps=50)
    p_plain, l_plain = ptrain.fit(
        bep, sim.params, xs_b, ptrain.batched_initial_state(sim, FIT_B),
        loss_fn, trainable=lambda s: s == path,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=5e-3),
        steps=FIT_STEPS)
    np.testing.assert_allclose(losses, l_plain, rtol=FIT_RTOL,
                               atol=FIT_ATOL)
    np.testing.assert_allclose(D, p_plain["probe"][str(pi)]["D"].numpy(),
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    # the JAX package's fit on its data mesh
    net, p = R.fit_net(JAX.nef, FIT_N)
    jsim = JaxSimulator(net, seed=3)
    jpi = jtrain.probe_index(jsim, p)
    scales, targ, mask = R.fit_targets(FIT_N, FIT_B)
    xs1 = jtrain.episode_inputs(jsim, FIT_N)
    jxs = np.stack([s * xs1 for s in scales])
    jbep = jtrain.make_batched_episode_fn(jsim, FIT_N, segment_steps=50)
    _, l_jax = jtrain.fit(
        jbep, jsim.params, jxs, jtrain.batched_initial_state(jsim, FIT_B),
        lambda e, f: jnp.sum(mask * (e[jpi] - targ) ** 2) / jnp.sum(mask),
        trainable=lambda s: s == f"probe/{jpi}/D",
        optimizer=optax.adam(5e-3), steps=FIT_STEPS,
        mesh=jax_make_mesh(8, axis_names=("data",)))
    np.testing.assert_allclose(losses, l_jax, rtol=FIT_RTOL, atol=FIT_ATOL)
    assert losses[-1] < losses[0] / 3


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_vco_scan_matches_jax_shard_map(ranks, vco, world):
    fpi, _, _, vels, corr = vco
    got, n_shards = ranks[world][0][1]
    assert n_shards == 1
    for res in ranks[world][1:]:
        assert np.array_equal(res[1][0], got)
    run = jax_shard_step.make_sharded_vco_scan(fpi.params,
                                               jax_make_mesh(world), VCO_T)
    state = run.initial_state()
    state, a = run(state, vels[:VCO_T], corr[:VCO_T])
    _, b = run(state, vels[VCO_T:], corr[VCO_T:])
    want = np.concatenate([np.asarray(a), np.asarray(b)])
    assert got.shape == want.shape and np.all(np.isfinite(want))
    assert np.abs(got - want).max() <= VCO_TOL


@pytest.mark.parametrize("world", [2, 4])
def test_fused_group_split_over_elements(ranks, world):
    """A k = 4 fused group split over its elements (2 and 1 a rank): its
    grouped decode, a neuron-level connection read in the same step, a
    decoded and an activity probe of single elements, against the port
    unsharded and the JAX mesh run (5e-4)."""
    got = ranks[world][0][-1]["traces"]
    sim, probes = R.build_sim("fused", {})
    sim.run_steps(FUSED_STEPS)
    net, jprobes = R.NETS["fused"](JAX)
    jsim = JaxSimulator(net, seed=0, mesh=jax_make_mesh(world))
    jsim.run_steps(FUSED_STEPS)
    assert len(got) == 4
    for k, (p, jp) in enumerate(zip(probes, jprobes)):
        for res in ranks[world][1:]:
            assert np.array_equal(res[-1]["traces"][k], got[k])
        for ref in (sim.data[p], np.asarray(jsim.data[jp])):
            assert got[k].shape == ref.shape and np.all(np.isfinite(got[k]))
            scale = max(1.0, float(np.abs(ref).max()))
            assert np.abs(got[k] - ref).max() <= MESH_TOL * scale, k
