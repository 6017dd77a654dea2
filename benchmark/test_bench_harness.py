"""The harness found by name, its contract's shapes, the traffic's
determinism, the imports, and the count arithmetic (CPU)."""

from __future__ import annotations

import ast
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import core, counts
from benchmark.harness import world as W

ROOT = Path(__file__).resolve().parents[1]
BENCH = core.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c, conf, cfg, mix = core.cell_files(BENCH, cell, ROOT)
    assert c["chips"] == 1
    assert (ROOT / "benchmark" / "entries" / f"{mix['entry']}.py").exists()
    entry = core.entry_module(mix["entry"])
    for f in ("setup", "unit", "trace_units", "program_outputs",
              "reference_check"):
        assert callable(getattr(entry, f))
    assert set(mix["limits"]) and all(v > 0 for v in mix["limits"].values())
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m["name"] for m in core.metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert core.metrics_of(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_by_name(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(core.reader(metric).read)
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    # each cell that reports the metric reports the metric it moves
    for cell in m.get("workloads", CELLS):
        assert m["moves"] in [x["name"] for x in
                              core.metrics_of(BENCH, cell, "end_to_end")]


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            names.append(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            if kind == "end_to_end":
                assert 0 < m["bound"] <= 0.25
                assert m["source"] in ("host_clock", "device_trace")
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    roof = [m for m in BENCH["per_layer"] if m["name"].endswith("_roofline")]
    assert roof and all(m["unit"] == "%" for m in roof)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_pi_traffic_deterministic():
    m = core.load_json(ROOT / "benchmark" / "traffic" / "fast.json")
    seed = 2 ** 31 + 77
    a, b = W.pi_episode(m, seed, 3), W.pi_episode(m, seed, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], W.pi_episode(m, seed, 4)[1])
    assert a[0].shape == (int(m["episode_s"] * 1000), 2)
    assert np.abs(a[0]).max() <= 0.9 + 1e-12


FORBIDDEN = {"jax", "jaxlib", "flax", "sspslam_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "benchmark").rglob("*.py")))
def test_no_jax_imports(path):
    # top-level names compared whole: sspslam_tpu_torch is not sspslam_tpu
    assert not set(_imports(ROOT / path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = ROOT / "benchmark" / "reference"
    for p in ref.rglob("*.py"):
        assert "sspslam_tpu_torch" not in set(_imports(p)), p
    code = ("import sys; import benchmark.reference.check, "
            "benchmark.reference.pi, benchmark.reference.ssp, "
            "benchmark.reference.vco; "
            "print(sorted(m.split('.')[0] for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert "sspslam_tpu_torch" not in tops and not tops & FORBIDDEN


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sspslam_tpu_torch_fake", object())
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert core.forbidden_modules() == ["jaxlib"]


def test_vco_chunk_bound():
    # the main path's chunk: 0.0727 ms at 37,216,110 spikes (chip_smoke.py)
    c = counts.vco_chunk(800, 49, 97, 2, 10_000, 37_216_110)
    assert c["bound_by"] == "operations"
    assert round(c["least_s"] * 1e3, 4) == 0.0727
    assert c["flops"] == 4_869_751_650 and c["bytes"] == 9_956_996


@pytest.mark.parametrize("name", CELLS)
def test_reference_builds_the_programs_tables(name):
    """The reference's own draws, space and solve give the program's
    tables (tiny widths, CPU): the elementwise ones to float32 rounding,
    the decoders by what they decode; TF32 operands do not."""
    import torch

    from benchmark import tiny
    from benchmark.reference import check, pi, ssp, vco
    import sspslam_tpu_torch as port
    cfg, mix = tiny.shrink(*core.cell_files(BENCH, name, ROOT)[2:])
    seed = 2 ** 31 + 9
    ms, n = W.model_seed(seed), cfg["domain_dim"]
    space = port.sspspace.HexagonalSSPSpace(
        n, ssp_dim=cfg["ssp_dim"], seed=ms, length_scale=cfg["length_scale"],
        domain_bounds=np.tile([-1.0, 1.0], (n, 1)))
    A = ssp.phase_matrix(n, cfg["ssp_dim"])
    assert np.array_equal(A, space.phase_matrix)
    x = np.random.default_rng(0).uniform(-1, 1, (7, n))
    assert np.allclose(ssp.encode(A, cfg["length_scale"], x),
                       space.encode(x), rtol=0, atol=1e-12)
    vel, corr, scale = pi.inputs(cfg, mix, seed, 1, A)
    torch.set_num_threads(1)
    fpi = port.models.FastPathIntegrator(
        space, cfg["pi_n_neurons"], cfg["recurrent_tau"],
        scaling_factor=scale, tau_probe=cfg["probe_synapse"], seed=ms,
        chunk_steps=mix["chunk_steps"], dt=cfg["dt"], device="cpu")
    ref = vco.bank(cfg, ms, scale, "cpu")
    prog = {m: getattr(fpi.params, m)
            for m in vco.TABLES + sum(vco.DECODERS.values(), ())}
    assert max(check.rel_gap(prog[m], ref[m]) for m in vco.TABLES) < 1e-12
    assert pi.decode_gap(prog, ref)[0] < 1e-5
    ctl = vco.bank(cfg, ms, scale, "cpu", tf32=True)
    assert pi.decode_gap({m: ctl[m] for m in prog}, ref)[0] > 1e-4


def test_spread_is_statistics_quartiles():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q = statistics.quantiles(v, n=4)
    assert (q[2] - q[0]) / statistics.median(v) == pytest.approx(1.0)


def test_trace_union_counts_overlap_once():
    from benchmark.harness import trace as tr
    dev = [("k1", 100, 200), ("k2", 150, 250), ("Memcpy HtoD", 400, 450)]
    spans = [("traced", 0, 1000), ("segment", 0, 500), ("pull", 500, 1000)]
    r = tr.reduce(dev, spans)
    assert r["busy_s"] == pytest.approx(200e-9)
    assert r["kernels"] == 2 and r["window_s"] == pytest.approx(1e-6)
    gaps = dict(r["idle_gaps"])
    # each gap is named by the span open at its middle
    assert gaps["pull"] == pytest.approx(550e-9)
    assert gaps["segment"] == pytest.approx(250e-9)
