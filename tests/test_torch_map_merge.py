"""The port's map-merging CLIs on the CPU against the JAX package's:
map_merge (offline delta merge into a learning-frozen localization run)
and live_merge (two agents as batched episodes with periodic exchange).

The JAX CLIs run as children (JAX_PLATFORMS=cpu, SSPSLAM_CLEANUP_F32=1,
one thread; map_merge's records its Simulators' traces); the port's
``main`` runs in this process.  Held:
- exact where it is arithmetic: the merged leaves equal the JAX formula
  ``base + (A - base) + (B - base)`` on the same float32 leaves (0); the
  live exchange equals ``A + B - M_prev`` in both episodes (0), in place;
  a live_merge arm whose ``--exchange-s`` exceeds ``--T`` equals the
  no-exchange arm (0);
- the same paths (assert_array_equal), the pinned velocity row, agent
  A's exploration trace within the spike-flip bounds of
  tests/torch_parity.py over the first 300 steps, and the JSON keys.
"""

import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch_parity import (assert_close, finish, jax_cli_module, key_tree,
                          last_json, run_port_cli, start_jax_cli)

from sspslam_tpu_torch.experiments import live_merge as pl
from sspslam_tpu_torch.experiments import map_merge as pm
from sspslam_tpu_torch.nef.simulator import _flatten
from sspslam_tpu_torch.parallel import BatchedEpisodes

STEPS = 300
WIDTHS = ["--ssp-dim", "25", "--n-landmarks", "5", "--pi-n-neurons", "80",
          "--mem-n-neurons", "90", "--circonv-n-neurons", "30",
          "--view-rad", "0.6"]
MERGE = [*WIDTHS, "--T-explore", "0.3", "--T-test", "0.3", "--limit", "4",
         "--eval-gate", "auto_recovery"]
# live_merge holds no traces: the narrowest widths
LIVE = ["--ssp-dim", "25", "--n-landmarks", "5", "--pi-n-neurons", "40",
        "--mem-n-neurons", "60", "--circonv-n-neurons", "10", "--view-rad",
        "0.6", "--T", "0.6", "--limit", "5", "--exchange-s", "0.2"]


@pytest.fixture(autouse=True)
def hoisted_f32(monkeypatch):
    for name in ("SSPSLAM_HOIST_CLEANUP", "SSPSLAM_HOIST_GATE",
                 "SSPSLAM_CLEANUP_F32"):
        monkeypatch.setenv(name, "1")
    # the port's small ops run fastest on one thread, beside the JAX child
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


# -- map_merge --------------------------------------------------------------
def test_merge_is_the_jax_formula():
    """``merge`` on tensors equals the JAX CLI's NumPy float32 formula on
    the same leaves, bit for bit."""
    rng = np.random.default_rng(0)
    shapes = {"pes_7": (90, 25), "voja_3": (90, 25)}
    la, lb, base = ({k: rng.standard_normal(s).astype(np.float32)
                     for k, s in shapes.items()} for _ in range(3))
    got = pm.merge(*({k: torch.from_numpy(v) for k, v in t.items()}
                     for t in (la, lb, base)))
    for k in shapes:
        want = base[k] + (la[k] - base[k]) + (lb[k] - base[k])
        np.testing.assert_array_equal(got[k].numpy(), want)


def test_inject_writes_the_state_in_place():
    """``inject`` resets the localization Simulator and copies a map into
    its learned state tensors without replacing any state leaf."""
    args = pm.parse_args([*MERGE, "--device", "cpu"])
    world = pm.make_worlds(args)
    sim, _, _ = pm.build_program(args, world, world["paths"][2],
                                 world["vels"][2], gate_mode="auto_recovery")
    sim.run_steps(20)
    before = [id(x) for x in _flatten(sim.state)]
    rng = np.random.default_rng(1)
    learned = {k.split("_")[0]: torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in sim.state["learned"].items()}
    pm.inject(sim, learned)
    assert [id(x) for x in _flatten(sim.state)] == before
    assert sim.n_steps == 0 and int(sim.state["step"]) == 0
    for k, v in sim.state["learned"].items():
        assert torch.equal(v, learned[k.split("_")[0]])


def test_map_merge_cli_matches_jax(tmp_path, monkeypatch):
    """The same three paths and pinned velocities; agent A's exploration
    trace within the spike-flip bounds; the same lines and JSON keys."""
    traces = tmp_path / "jax.npz"
    proc = start_jax_cli("map_merge.py", ["--cpu", *MERGE], traces=traces)
    result, pout = run_port_cli("map_merge", [*MERGE, "--device", "cpu"])
    args = pm.parse_args([*MERGE, "--device", "cpu"])
    world = pm.make_worlds(args)
    jm = jax_cli_module("map_merge")
    for got, seed, xr in zip(world["paths"], (0, 500, 900),
                             ((-0.9, -0.05), (0.05, 0.9), (-0.9, 0.9))):
        T = args.T_test if seed == 900 else args.T_explore
        want = jm.make_path(T, 0.001, args.limit, seed, xr, (-0.9, 0.9))
        np.testing.assert_array_equal(got, want[:int(T / 0.001)])
    seen = {}

    def adapter(space, lm_space, vels, vec, vr):
        seen.setdefault("vels", vels)
        raise RuntimeError("recorded")
    monkeypatch.setattr(jm, "get_slam_input_functions2", adapter)
    monkeypatch.setattr(sys, "argv", ["map_merge.py", *MERGE])
    with pytest.raises(RuntimeError, match="recorded"):
        jm.main()
    np.testing.assert_array_equal(world["vels"][0], seen["vels"])

    sim, probe, _ = pm.build_program(args, world, world["paths"][0],
                                     world["vels"][0])
    sim.run_steps(STEPS)
    jout = finish(proc)
    ref = last_json(jout)
    assert key_tree(result) == key_tree(ref)
    for key in ("T_explore", "T_test", "ssp_dim", "n_landmarks", "seed"):
        assert result[key] == ref[key]
    idx = next(bp.index for bp in sim.model.probes if bp.obj is probe)
    jtr = np.load(traces)
    assert sorted(jtr.files) == [f"s{i}_p{idx}" for i in range(3)]
    assert_close(sim.data[probe], jtr[f"s0_p{idx}"][:STEPS], spiking=True,
                 what="agent A")
    for prefix in ("agent A: explored", "agent B: explored", "map ",
                   "merged ", "agent_A_only ", "agent_B_only ", "empty "):
        for out in (pout, jout):
            assert any(line.startswith(prefix)
                       for line in out.splitlines()), prefix


# -- live_merge -------------------------------------------------------------
def _live(argv):
    return pl.build(pl.parse_args([*argv, "--device", "cpu"]))


def test_exchange_is_a_plus_b_minus_prev():
    """One exchange on the batched state: both episodes' learned leaves
    become ``A + B - M_prev`` (the JAX CLI's formula on the same float32
    leaves), written into the same tensors; the base becomes that
    leaf."""
    built = _live(LIVE)
    runner = BatchedEpisodes(built["sim"], built["tables"])
    runner.run(30)
    rng = np.random.default_rng(2)
    host, base = {}, {}
    for k, leaf in runner.state["learned"].items():
        host[k] = rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
        leaf.copy_(torch.from_numpy(host[k]))
        base[k] = torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape[1:])).astype(np.float32))
    prev = {k: v.numpy().copy() for k, v in base.items()}
    ids = {k: (id(v), v.data_ptr())
           for k, v in runner.state["learned"].items()}
    pl.exchange(runner, base)
    for k, leaf in runner.state["learned"].items():
        want = host[k][0] + host[k][1] - prev[k]
        assert (id(leaf), leaf.data_ptr()) == ids[k]
        np.testing.assert_array_equal(leaf[0].numpy(), want)
        np.testing.assert_array_equal(leaf[1].numpy(), want)
        np.testing.assert_array_equal(base[k].numpy(), want)


def test_exchange_beyond_T_equals_no_exchange():
    """An exchange period longer than the run leaves one segment and no
    exchange: the arm equals the no-exchange arm, bit for bit."""
    built = _live([*LIVE[:-2], "--exchange-s", "5"])
    seg, per = 5000, 50
    on, _ = pl.run_arm(built, seg, per, True)
    off, _ = pl.run_arm(built, seg, per, False)
    assert on.shape == (2, 600 // per, 25)
    np.testing.assert_array_equal(on, off)


def test_live_merge_cli_matches_jax():
    """The same crossover paths, the JAX CLI's JSON keys and lines."""
    proc = start_jax_cli("live_merge.py", ["--cpu", *LIVE])
    result, pout = run_port_cli("live_merge", [*LIVE, "--device", "cpu"])
    jl = jax_cli_module("live_merge")
    args = pl.parse_args([*LIVE, "--device", "cpu"])
    for seed, side in ((args.seed, -1), (args.seed + 500, 1)):
        np.testing.assert_array_equal(
            pl.make_crossover_path(args.T, 0.001, args.limit, seed, side),
            jl.make_crossover_path(args.T, 0.001, args.limit, seed, side))
    jout = finish(proc)
    ref = last_json(jout)
    assert key_tree(result) == key_tree(ref)
    for key in ("metric", "exchange_s", "T", "ssp_dim", "seed", "unit"):
        assert result[key] == ref[key]
    for prefix in ("worlds: built", "model built:", '{"exchange"',
                   '{"no_exchange"'):
        for out in (pout, jout):
            assert any(line.startswith(prefix)
                       for line in out.splitlines()), prefix
    assert [line for line in pout.splitlines()
            if line.startswith("model built")] == \
        [line for line in jout.splitlines() if line.startswith("model built")]
