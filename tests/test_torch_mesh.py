"""The port's model-axis sharding (``Simulator(mesh=...)``) on gloo ranks
on the CPU against the JAX package's mesh runs (``Simulator(mesh=
make_mesh(n))`` on the conftest's virtual CPU devices) and against the
port's unsharded Simulator.

- The split axis of every state and parameter leaf: the port's
  ``state_shardings`` / ``params_shardings`` against the JAX package's
  at mesh 2 and 4 (int8 banks included), and the sharded step's own
  layout equal to them on these models, but for the int8 model's
  decoded 40-wide output filter, which the step keeps whole.
- tests/test_parallel.py's PI network and its anchored, gated SLAM
  (LIFRate) at world 2 and 4: every probe within 5e-4 of the JAX mesh
  run (test_parallel.py's mesh-vs-single bound) and of the port's
  unsharded run; the memory's neuron probe (gathered from the ranks) and
  decoded probe too; the same rows on every rank.
- The checkpoint of a sharded run: the same file as the JAX mesh
  Simulator's at that step (leaves within 1e-4 relative), which the JAX
  package loads and continues within 5e-4; a fresh sharded Simulator
  resumed from it reproduces the uninterrupted run bit for bit, and
  ``reset`` replays the first half bit for bit.
- The clean-up's argmax over a bank split over 4 ranks, on constructed
  ties across and within ranks: ``jnp.argmax``'s first index.
- More CUDA ranks than cards raise before anything starts; a sharded
  Simulator's serving bundle is refused (not ported yet).
"""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from torch_parity import spawn_ranks

from sspslam_tpu.nef import Simulator as JaxSimulator
from sspslam_tpu.parallel import make_mesh as jax_make_mesh
from sspslam_tpu.parallel import sharding as jsh
from sspslam_tpu.ops.quantize import QTensor as JaxQTensor

from sspslam_tpu_torch.nef.builder import build as port_build
from sspslam_tpu_torch.nef.executor import build_params
from sspslam_tpu_torch.ops.quantize import QTensor
from sspslam_tpu_torch.parallel import sharding as psh

JAX = R.lib("sspslam_tpu")
MESH_TOL = 5e-4
CKPT_RTOL = 1e-4
STEPS = {"pi": 100, "slam": 200}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mesh_run(name, world, n_steps, ckpt_at=None, ckpt=None):
    """The JAX package's mesh Simulator of ``name`` over ``n_steps`` (a
    checkpoint written at ``ckpt_at``); its probes' traces."""
    net, probes = R.NETS[name](JAX)
    sim = JaxSimulator(net, seed=0, mesh=jax_make_mesh(world),
                       **R.sim_kwargs(name, JAX))
    if ckpt_at is not None:
        sim.run_steps(ckpt_at)
        sim.save_checkpoint(ckpt)
        sim.run_steps(n_steps - ckpt_at)
    else:
        sim.run_steps(n_steps)
    return [np.asarray(sim.data[p]) for p in probes]


@pytest.fixture(scope="module", params=[2, 4])
def world_runs(request, tmp_path_factory):
    """One spawn of ``world`` ranks running the PI network and the
    anchored SLAM, each with a checkpoint at half time; the JAX mesh runs
    and the port's unsharded runs beside them."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"mesh{world}")
    ck = {name: str(tmp / f"{name}.npz") for name in STEPS}
    jobs = [("run_sharded", (name, {}, STEPS[name], {}, ck[name]))
            for name in STEPS]
    if world == 4:
        jobs.append(("run_tie", tie_case()))
    ranks = spawn_ranks(R.run_jobs, world, tmp, args=(jobs,))
    out = {"world": world, "ranks": ranks, "ckpt": ck, "jax": {},
           "jax_ckpt": {}, "unsharded": {}}
    for name, n in STEPS.items():
        out["jax_ckpt"][name] = str(tmp / f"jax_{name}.npz")
        out["jax"][name] = jax_mesh_run(name, world, n, n // 2,
                                        out["jax_ckpt"][name])
        sim, probes = R.build_sim(name, {})
        sim.run_steps(n)
        out["unsharded"][name] = [sim.data[p] for p in probes]
    return out


@pytest.mark.parametrize("name", ["pi", "slam"])
def test_sharded_run_matches_jax_mesh_and_unsharded(world_runs, name):
    i = list(STEPS).index(name)
    first = world_runs["ranks"][0][i]
    for r, res in enumerate(world_runs["ranks"]):
        for a, b in zip(res[i]["traces"], first["traces"]):
            assert np.array_equal(a, b), f"rank {r} differs from rank 0"
    for k, got in enumerate(first["traces"]):
        jax_want = world_runs["jax"][name][k]
        plain = world_runs["unsharded"][name][k]
        assert got.shape == jax_want.shape == plain.shape
        assert np.all(np.isfinite(got))
        scale = max(1.0, float(np.abs(jax_want).max()))
        assert np.abs(got - jax_want).max() <= MESH_TOL * scale, (name, k)
        assert np.abs(got - plain).max() <= MESH_TOL * scale, (name, k)
    stats = first["stats"]
    assert stats["all_reduces"] >= 1 and stats["bytes"] > 0, stats
    assert first["bundle_refused"]
    if name == "slam":
        # the bucketed step: as many all-reduces as the JAX package's
        # GSPMD program issues at d = 97 (docs/MULTICHIP.md), no more
        assert stats["all_reduces"] <= 8, stats


@pytest.mark.parametrize("name", ["pi", "slam"])
def test_checkpoint_of_sharded_run(world_runs, name):
    i = list(STEPS).index(name)
    n = STEPS[name]
    res = world_runs["ranks"][0][i]
    with np.load(world_runs["ckpt"][name]) as f, \
            np.load(world_runs["jax_ckpt"][name]) as g:
        assert set(f.files) == set(g.files)
        assert int(f["n_steps"]) == int(g["n_steps"]) == n // 2
        for key in f.files:
            a, b = f[key], g[key]
            assert a.shape == b.shape, key
            if a.dtype.kind == "f":
                scale = max(1.0, float(np.abs(b).max()))
                assert np.abs(a - b).max() <= CKPT_RTOL * scale, key
            else:
                assert np.array_equal(a, b), key
    # the port's file, loaded by the JAX package's mesh Simulator
    net, probes = R.NETS[name](JAX)
    jsim = JaxSimulator(net, seed=0,
                        mesh=jax_make_mesh(world_runs["world"]),
                        **R.sim_kwargs(name, JAX))
    jsim.load_checkpoint(world_runs["ckpt"][name])
    jsim.run_steps(n - n // 2)
    for k, p in enumerate(probes):
        want = np.asarray(jsim.data[p])
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(res["resumed"][k] - want).max() <= MESH_TOL * scale
        # resumed from the file = the uninterrupted run, bit for bit
        assert np.array_equal(res["resumed"][k],
                              res["traces"][k][n // 2:])
        assert np.array_equal(res["after_reset"][k],
                              res["traces"][k][:n // 2])


def tie_case():
    """A 16-row bank (4 rows a rank at world 4) and three queries: the
    first's best similarity ties between rows 1 and 9 (ranks 0 and 2),
    the second's between rows 6 and 7 (both rank 1) and 14 (rank 3), the
    third has one best row.  Tied rows differ outside the query's
    direction, so the pick is visible."""
    rng = np.random.default_rng(0)
    bank = rng.uniform(-0.5, 0.5, size=(16, 6)).astype(np.float32)
    bank[:, 0] = np.linspace(-0.9, 0.2, 16).astype(np.float32)
    bank[[1, 9], 0] = 0.75
    bank[[6, 7, 14], 3] = 0.8
    queries = np.zeros((3, 6), np.float32)
    queries[0, 0] = 1.0
    queries[1, 3] = 1.0
    queries[2] = bank[12]
    return bank, queries


@pytest.mark.parametrize("world_runs", [4], indirect=True)
def test_cleanup_argmax_ties_keep_jnp_argmax_first_index(world_runs):
    import jax.numpy as jnp
    bank, queries = tie_case()
    got, n_collectives = world_runs["ranks"][0][-1]
    sims = jnp.einsum("md,qd->qm", jnp.asarray(bank, jnp.bfloat16),
                      jnp.asarray(queries, jnp.bfloat16))
    want = bank[np.asarray(jnp.argmax(sims, axis=-1))]
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], bank[1])
    assert np.array_equal(got[1], bank[6])
    assert np.array_equal(got[2], bank[12])
    assert n_collectives == 3
    for res in world_runs["ranks"][1:]:
        assert np.array_equal(res[-1][0], got)


def _jax_axis(ns, name="model"):
    spec = tuple(ns.spec)
    return spec.index(name) if name in spec else None


def _axes_by_path(tree, to_axis, path=()):
    """{path: axis} of a sharding tree; a quantised leaf gives its
    payload's and its scale's; hoisted entries are keyed by their table
    names (the packages number them differently)."""
    if isinstance(tree, dict):
        if path == ("hoisted",):
            return {("hoisted", tuple(sorted(v)), k2): to_axis(a)
                    for v in tree.values() for k2, a in v.items()}
        return {k: v for key in tree
                for k, v in _axes_by_path(tree[key], to_axis,
                                          path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _axes_by_path(x, to_axis, path + (i,)).items()}
    if isinstance(tree, (QTensor, JaxQTensor)):
        return {path + ("q",): to_axis(tree.q),
                path + ("s",): to_axis(tree.s)}
    return {path: to_axis(tree)}


@pytest.mark.parametrize("name,world,dtype", [
    ("pi", 2, None), ("pi", 4, None), ("slam", 2, None), ("slam", 4, None),
    ("int8", 2, "int8"), ("int8", 4, "int8")])
def test_split_axes_equal_jax(monkeypatch, name, world, dtype):
    for var in ("SSPSLAM_HOIST_CLEANUP", "SSPSLAM_HOIST_GATE"):
        monkeypatch.setenv(var, "1")
    mesh = jax_make_mesh(world)
    jnet, _ = R.NETS[name](JAX)
    jsim = JaxSimulator(jnet, seed=0, mesh=mesh, matmul_dtype=dtype)
    pnet, _ = R.NETS[name]()
    model = port_build(pnet, dt=0.001, seed=0, pad_batched_to=world,
                       device="cpu")
    params = build_params(model, dtype, device="cpu")
    want_state = _axes_by_path(jsh.state_shardings(jsim.model, mesh),
                               _jax_axis)
    got_state = _axes_by_path(psh.state_shardings(model, world), lambda a: a)
    assert got_state == want_state
    want_p = _axes_by_path(
        jsh.params_shardings(jsim.params, mesh, model=jsim.model), _jax_axis)
    got_p = _axes_by_path(psh.params_shardings(params, world, model=model),
                          lambda a: a)
    assert got_p == want_p
    assert any(a is not None for a in got_p.values())
    # the sharded step reads every leaf as these rules split it, except
    # a filter of a decoded value that every rank reads whole (the int8
    # model's 40-wide output filter, which the JAX rule splits)
    diffs = psh.layout_differences(model, params, world)
    assert all(path.startswith("state/filters/") and mine is None
               for path, _, mine in diffs), diffs
    assert len(diffs) == (1 if name == "int8" else 0), diffs


def test_more_cuda_ranks_than_cards_raise(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psh.spawn(R.run_jobs, 2, "cuda", args=([],))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA ranks but 1 cards"):
        psh.spawn(R.run_jobs, 2, "cuda", args=([],),
                  rendezvous_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="4 CUDA ranks but 1 cards"):
        psh.init_rank(0, 4, "file://" + str(tmp_path / "r"), "cuda")
