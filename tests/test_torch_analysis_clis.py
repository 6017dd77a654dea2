"""The port's analysis CLIs on the CPU against the JAX package's:
gate_fidelity, bf16_drift, scale_study and redecode_scaled; and the
refusal of ``--plot`` by every CLI this slice ports (none of their JAX
counterparts takes it).

The JAX CLIs run as children (JAX_PLATFORMS=cpu, SSPSLAM_CLEANUP_F32=1,
one thread); the port's ``main`` runs in this process.  Held:
- gate_fidelity (LIFRate): the same table, median error and engaged
  fraction within 1e-3 (a rate network; the decoded error is an argmax);
- bf16_drift: the same configuration line; the float32 run's errors and
  the float32-vs-bf16 trajectory cosines within 1e-3;
- scale_study: MFLOP/step equal to the JAX package's
  ``model_utilization_summary`` of ``bench.py --model slam``'s model at
  the same ssp_dim (exact: integer counts of the built shapes);
- redecode_scaled on one npz: the grid medians equal, the polished
  medians within 1e-4 (the Newton polish's tolerance, ROADMAP.md Queue 3),
  the same JSON keys.
"""

import argparse
import importlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch_parity import finish, key_tree, last_json, run_port_cli, \
    start_jax_cli

from sspslam_tpu_torch.experiments.common import slam_simulator, slam_world
from sspslam_tpu_torch.sspspace import HexagonalSSPSpace
from sspslam_tpu_torch.utils.profiling import model_utilization_summary

REPO = Path(__file__).resolve().parents[1]
RATE_TOL = 1e-3
NEWTON_TOL = 1e-4
NUMBER = re.compile(r"[-+]?\d+\.\d+")

GATE = ["--T", "1", "--ssp-dim", "19", "--pi-n-neurons", "40",
        "--mem-n-neurons", "60", "--circonv-n-neurons", "10",
        "--n-landmarks", "3"]
DRIFT = ["--T", "1", "--ssp-dim", "19", "--pi-n-neurons", "40",
         "--segment-steps", "250", "--limit", "2"]
# each ported CLI and the arguments it requires
CLIS = {"validate_loop_closure": [], "kidnapped_robot": [],
        "check_anchor_enters": ["d.npz", "--seed", "0", "--enters", "1"],
        "make_example_paths": [], "map_merge": [], "live_merge": [],
        "gate_fidelity": [], "bf16_drift": [], "scale_study": [],
        "redecode_scaled": ["s.npz"]}


@pytest.fixture(autouse=True)
def f32_cleanup(monkeypatch):
    monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
    # the port's small ops run fastest on one thread, beside the JAX child
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def numbers(line):
    return [float(x) for x in NUMBER.findall(line)]


def line_of(out, prefix):
    (line,) = [l for l in out.splitlines() if l.startswith(prefix)]
    return line


def test_gate_fidelity_matches_jax():
    proc = start_jax_cli("gate_fidelity.py", GATE)
    rows, pout = run_port_cli("gate_fidelity", [*GATE, "--device", "cpu"])
    jout = finish(proc)
    assert line_of(pout, "gate ") == line_of(jout, "gate ")
    for sem, thres, err, engaged in rows:
        prefix = f"{sem:8} {thres:<6}"
        got, want = line_of(pout, prefix), line_of(jout, prefix)
        assert got.split("#")[1] == want.split("#")[1]
        np.testing.assert_allclose(numbers(got.split("#")[0]),
                                   numbers(want.split("#")[0]),
                                   atol=RATE_TOL, rtol=0)
        assert np.isfinite(err) and 0 <= engaged <= 1


def test_bf16_drift_matches_jax():
    proc = start_jax_cli("bf16_drift.py", ["--cpu", *DRIFT])
    res, pout = run_port_cli("bf16_drift", [*DRIFT, "--device", "cpu"])
    jout = finish(proc)
    assert line_of(pout, "config:") == line_of(jout, "config:")
    f32 = [numbers(line_of(out, "f32  :"))[:3] for out in (pout, jout)]
    np.testing.assert_allclose(*f32, atol=RATE_TOL, rtol=0)
    cos = [numbers(line_of(out, "f32-vs-bf16")) for out in (pout, jout)]
    np.testing.assert_allclose(*cos, atol=RATE_TOL, rtol=0)
    for out in (pout, jout):
        line_of(out, "bf16 :")
        line_of(out, "bf16 speedup:")
    assert all(s > 0 for s in res["steps_per_s"])


def test_scale_study_mflop_matches_jax():
    """The port's row at ssp_dim 19 (f32 and bf16) against the JAX
    package's model summary of bench.py's build at the same width."""
    rows, out = run_port_cli("scale_study", [
        "--dims", "19", "--steps", "50", "--segment-steps", "50",
        "--reps", "1", "--device", "cpu"])
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    from sspslam_tpu.utils.profiling import \
        model_utilization_summary as jax_summary
    args = argparse.Namespace(
        ssp_dim=19, pi_n_neurons=800, mem_n_neurons=190,
        circonv_n_neurons=100, n_landmarks=10, cleanup_samples=100,
        seed=0, scan_unroll=8, bf16=False, world_T=14.0)
    jsim, *_ = bench.build(args)
    want = sum(r["flops_per_step"] for r in jax_summary(jsim.model))
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=19, seed=0, length_scale=0.3,
                              domain_bounds=bounds)
    sim, _, _ = slam_simulator(space, slam_world(14.0, 10, 0),
                               mem_n_neurons=190, device="cpu")
    assert sum(r["flops_per_step"]
               for r in model_utilization_summary(sim.model)) == want
    assert [r["bf16"] for r in rows] == [False, True]
    for r in rows:
        assert r["mflop_per_step"] == round(want / 1e6, 2)
        assert r["neurons"] == sum(
            (be.k * be.n if be.batched else be.n)
            for be in jsim.model.ensembles)
        assert r["steps_per_s"] > 0
    assert "| d | LIF neurons | params dtype | MFLOP/step |" in out


def _scaled_npz(path):
    """A scaled_slam --save npz: two seeds' probed SSPs (the encoded true
    path plus noise, every 10th step) beside the paths."""
    rng = np.random.default_rng(0)
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=25, seed=4, length_scale=0.3,
                              domain_bounds=bounds)
    n, per = 400, 10
    paths = np.cumsum(rng.normal(0, 0.01, (2, n, 2)), axis=1)
    outs = np.stack([space.encode(p[per - 1::per])
                     + 0.05 * rng.standard_normal((n // per, 25))
                     for p in paths]).astype(np.float32)
    meta = {"config": {"domain_dim": 2, "ssp_dim": 25, "length_scale": 0.3},
            "per_seed": [{"seed": 4}, {"seed": 5}]}
    np.savez(path, slam_out=outs, pi_out=outs[:, ::-1].copy(), paths=paths,
             meta=np.array([json.dumps(meta)]))


def test_redecode_scaled_matches_jax(tmp_path):
    fn = tmp_path / "scaled_slam_d25.npz"
    _scaled_npz(fn)
    proc = start_jax_cli("redecode_scaled.py", [str(fn), "--cpu"])
    (res,), pout = run_port_cli("redecode_scaled",
                                [str(fn), "--device", "cpu"])
    jout = finish(proc)
    ref = last_json(jout)
    assert key_tree(res) == key_tree(ref)
    assert res["median_grid"] == ref["median_grid"]
    assert abs(res["median_polished"] - ref["median_polished"]) \
        <= NEWTON_TOL
    for mine, theirs in zip(res["per_seed"], ref["per_seed"]):
        for name in ("slam", "pi_only"):
            assert mine[name]["grid"] == theirs[name]["grid"]
            assert abs(mine[name]["polished"] - theirs[name]["polished"]) \
                <= NEWTON_TOL
    assert res["median_polished"] < res["median_grid"]
    assert len(pout.splitlines()) == len(jout.splitlines()) == 3


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_refuses_plot(name, capsys):
    """None of these JAX CLIs takes ``--plot``; the port's refuse it as
    argparse refuses it there (exit code 2), before building anything."""
    cli = importlib.import_module(f"sspslam_tpu_torch.experiments.{name}")
    with pytest.raises(SystemExit) as exc:
        cli.main([*CLIS[name], "--plot"])
    assert exc.value.code == 2
    assert "unrecognized arguments: --plot" in capsys.readouterr().err
