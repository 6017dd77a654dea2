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
- The sharded serving bundle of those runs (saved by the ranks from the
  fresh state, one program a model coordinate): ``ServingModel`` on
  every rank serves the first half from the bundle's state, then (after
  ``reset`` and a segment) the second half from ``load_state`` of the
  half-way checkpoint: rows within 1e-6 of the live sharded rows (equal
  in practice) and within 5e-4 of the JAX mesh rows; each program holds
  as many all-reduces as the live step; ``arrays.npz`` is an unsharded
  bundle's of the same build, leaf for leaf; a serving world of another
  size raises before any step.  At world 2
  the PI network's served rows lie within 5e-4 of the JAX package's own
  sharded ``save_bundle`` / ``ServingModel`` of ``Simulator(mesh=
  make_mesh(2))``.  At world 4, a (2, 2) ("data", "model") mesh: the
  data-1 ranks serve a program that names another process group than
  theirs, renamed to their own, and every rank gives the live rows.
- More CUDA ranks than cards raise before anything starts.
"""

import os

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from torch_parity import spawn_ranks

from sspslam_tpu.nef import ServingModel as JaxServingModel
from sspslam_tpu.nef import Simulator as JaxSimulator
from sspslam_tpu.nef import save_bundle as jax_save_bundle
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
SERVED_TOL = 1e-6
STEPS = {"pi": 100, "slam": 200}
DP_TP_STEPS = 60


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
    jobs = [("run_sharded", (name, {}, STEPS[name], {}, ck[name],
                             str(tmp / f"{name}_bundle")))
            for name in STEPS]
    # a (data, model) mesh of (2, world / 2): the data-1 ranks serve a
    # program that names the data-0 row's model group
    jobs.append(("run_dp_tp_bundle", ("pi", DP_TP_STEPS, (2, world // 2),
                                      str(tmp / "dp_tp_bundle"))))
    if world == 4:
        jobs.append(("run_tie", tie_case()))
    ranks = spawn_ranks(R.run_jobs, world, tmp, args=(jobs,))
    out = {"world": world, "ranks": ranks, "ckpt": ck, "jax": {},
           "jax_ckpt": {}, "unsharded": {}, "tmp": tmp}
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


def _served(world_runs, name):
    i = list(STEPS).index(name)
    return i, [res[i] for res in world_runs["ranks"]]


@pytest.mark.parametrize("name", ["pi", "slam"])
def test_served_sharded_bundle_matches_live_and_jax_mesh(world_runs, name):
    i, ranks = _served(world_runs, name)
    for r, res in enumerate(ranks):
        for k, (got, live) in enumerate(zip(res["served"]["rows"],
                                            res["traces"])):
            assert got.shape == live.shape and np.all(np.isfinite(got))
            err = float(np.abs(got - live).max())
            print(f"world {world_runs['world']} {name} rank {r} probe {k}:"
                  f" served vs live max-abs {err}")
            assert err <= SERVED_TOL, (r, k, err)
            want = world_runs["jax"][name][k]
            scale = max(1.0, float(np.abs(want).max()))
            assert np.abs(got - want).max() <= MESH_TOL * scale, (r, k)


@pytest.mark.parametrize("name", ["pi", "slam"])
def test_sharded_bundle_programs_and_arrays(world_runs, name):
    """One program a model coordinate, each with the live step's
    all-reduces; the whole trees once, as an unsharded bundle of the same
    build writes them; the JAX package's mesh keys."""
    world = world_runs["world"]
    i, ranks = _served(world_runs, name)
    mm = ranks[0]["served"]["meta_mesh"]
    assert mm["axis_names"] == ["model"] and mm["shape"] == [world]
    assert mm["programs"] == [f"step.model{c}.pt2" for c in range(world)]
    bundle = world_runs["tmp"] / f"{name}_bundle"
    assert sorted(os.listdir(bundle)) == sorted(
        ["arrays.npz", "meta.json"] + mm["programs"])
    live = ranks[0]["stats"]["all_reduces"]
    assert [res["served"]["program_all_reduces"] for res in ranks] == \
        [live] * world, live
    assert mm["all_reduces_per_step"] == live
    with np.load(bundle / "arrays.npz") as f:
        got = {k: f[k] for k in f.files}
    (want,) = [res["served"]["plain_arrays"] for res in ranks
               if "plain_arrays" in res["served"]]
    assert sorted(got) == sorted(want)
    assert len(mm["params_specs"]) == sum(k[0] == "p" for k in want)
    assert len(mm["state_specs"]) == sum(k[0] == "s" for k in want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    split = [e for e in mm["params_specs"] + mm["state_specs"] if e]
    assert split and all(e[-1] == "model" for e in split)


@pytest.mark.parametrize("name", ["pi", "slam"])
def test_served_sharded_bundle_resumes_and_resets(world_runs, name):
    """``load_state`` of the sharded run's half-way checkpoint (the whole
    state in one file) serves the live second half from a state it must
    replace, ``reset`` the first segment again after the first half; a
    serving world of another size raises before any step."""
    n = STEPS[name]
    world = world_runs["world"]
    i, ranks = _served(world_runs, name)
    for res in ranks:
        served = res["served"]
        for k, live in enumerate(res["traces"]):
            assert np.abs(served["resumed"][k] - live[n // 2:]).max() \
                <= SERVED_TOL
            first = live[:R.BUNDLE_SEGMENT]
            assert np.abs(served["after_reset"][k] - first).max() \
                <= SERVED_TOL
        msg = served["wrong_world"]
        assert msg is not None and f"[{world + 1}] mesh" in msg \
            and f"has {world} ranks" in msg, msg
        assert served["groups"] == ("0", "0")


def test_dp_tp_bundle_renames_process_group(world_runs):
    """A (2, world / 2) ("data", "model") mesh: the programs (traced at
    data coordinate 0) name that row's model group; every rank serves
    over its own model group of a mesh built anew, and gives the live
    rows."""
    jobs = [res[len(STEPS)] for res in world_runs["ranks"]]
    recorded = {j["groups"][1] for j in jobs}
    assert len(recorded) == 1
    assert len(jobs[0]["programs"]) == world_runs["world"] // 2
    (recorded,) = recorded
    for r, j in enumerate(jobs):
        own_then, _, own_now = j["groups"]
        assert (own_then == recorded) == (j["coords"][0] == 0), j["groups"]
        assert own_now != recorded
        for got, live in zip(j["served"], j["live"]):
            assert got.shape == live.shape and np.all(np.isfinite(got))
            assert np.abs(got - live).max() <= SERVED_TOL, r
    # the data-1 replica serves over another group than the data-0 one
    assert {j["groups"][2] for j in jobs if j["coords"][0] == 1}.isdisjoint(
        {j["groups"][2] for j in jobs if j["coords"][0] == 0})


def test_served_bundle_matches_jax_sharded_serving(world_runs, tmp_path):
    """tests/test_export.py::test_mesh_bundle_roundtrip's counterpart:
    the JAX package's own sharded bundle of the PI network at the same
    mesh, served by its ServingModel, against the port's served rows."""
    name, n, world = "pi", STEPS["pi"], world_runs["world"]
    net, probes = R.NETS[name](JAX)
    jsim = JaxSimulator(net, seed=0, mesh=jax_make_mesh(world),
                        **R.sim_kwargs(name, JAX))
    xs = np.asarray(jsim._pack_cols(jsim._tabulate_inputs(n)), np.float32)
    jax_save_bundle(jsim, str(tmp_path / "jax"), segment_steps=n // 2)
    jm = JaxServingModel(str(tmp_path / "jax"))
    assert jm.mesh is not None and jm.mesh.devices.size == world
    (label,) = [d["label"] for d in jm.meta["probes"]]
    want = jm.run(xs)[label]
    i, ranks = _served(world_runs, name)
    for res in ranks:
        got = res["served"]["rows"][0]
        assert got.shape == want.shape
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= MESH_TOL * scale


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
