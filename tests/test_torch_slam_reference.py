"""The benchmark's plain SLAM reference (``benchmark/reference/slam.py``)
against the port at tiny widths on the CPU: it rebuilds the program's
tables and decoders from its own draws, follows the program's state for
K steps (outputs and the learned PES and Voja leaves), its step counts
match a hand count, and it loads nothing of the program or of JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import tiny_slam
from benchmark.harness import cell, core, slam_counts
from benchmark.reference import check, slam, slam_check

ROOT = Path(__file__).resolve().parents[1]
BENCH = core.load_benchmark(ROOT)
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def run():
    """The cell's entry driven unit by unit at tiny widths (set-up, every
    unit up to the judged one's end, the program's outputs), the
    reference built and stepped from rest and from the judged state."""
    torch.set_num_threads(1)
    c, _, cfg, mix = core.cell_files(BENCH, "slam-d97.b1", ROOT)
    cfg, mix = tiny_slam.shrink(cfg, mix)
    ctx = cell.Context(BENCH, c, cfg, mix, SEED, 0.0, False,
                       torch.device("cpu"))
    entry = core.entry_module(mix["entry"])
    st = entry.setup(ctx)
    for _ in range(st["pick"] + 1):
        entry.unit(ctx, st)
    out = entry.program_outputs(ctx, st)
    wd = slam_check.world(cfg, mix, SEED)
    net = slam.build(cfg, wd["ms"], wd["scale"], "cpu")
    y0, after, rows = slam_check.reference_runs(cfg, mix, out, net, wd,
                                                "cpu")
    return {"cfg": cfg, "mix": mix, "out": out, "net": net, "wd": wd,
            "y0": y0, "after": after, "rows": rows}


def test_tables_rebuilt(run):
    ref = slam_check.ref_tables(run["net"])
    prog = run["out"]["tables"]
    assert set(ref) == set(prog)
    for name, r in ref.items():
        if name.endswith(".dtype"):
            assert prog[name] == r == "torch.bfloat16"
        else:
            assert check.rel_gap(prog[name], r) < 1e-6, name


def test_decoders_decode_alike(run):
    gap, where = slam_check.decode_gap(run["out"]["decoders"], run["net"])
    assert gap < 2e-5, where


def test_steps_from_rest_agree(run):
    assert check.oscillator_gap(run["out"]["first"], run["y0"]) < 1e-4


def test_steps_from_a_program_state_agree(run):
    out, after = run["out"], run["after"]
    assert out["replay_equal"]
    assert check.oscillator_gap(out["chunk_rows"], run["rows"]) < 1e-4
    for name in ("error_recall", "estimate", "vco_rec", "pes_act"):
        assert check.rel_gap(out["after"][name], after[name]) < 1e-4, name
    for name in slam.LEARNED:
        moved = check.host(after[name]) - out["snap"][name]
        assert np.linalg.norm(moved) > 0, name
        assert slam_check.delta_gap(out["after"][name], out["snap"][name],
                                    after[name], out["snap"][name]) < 1e-4


def test_control_parts_from_the_reference(run):
    ctl = slam.build(run["cfg"], run["wd"]["ms"], run["wd"]["scale"], "cpu",
                     tf32=True)
    assert slam_check.decode_gap({k: ctl["dec"][k] for k in slam.DECODERS},
                                 run["net"])[0] > 1e-4
    assert slam_check.table_gap(slam_check.ref_tables(ctl),
                                slam_check.ref_tables(run["net"]))[0] > 1e-5


def test_step_counts_by_hand():
    cfg = dict(ssp_dim=25, pi_n_neurons=40, mem_n_neurons=60,
               circonv_n_neurons=20, cleanup_samples_per_dim=30,
               domain_dim=2)
    # k = 13 oscillators, 4h = 52 channels, 104 squaring populations of
    # 10 a convolution, a 900-point grid
    macs = (13 * 40 * 3 + 13 * 40 * 6 + 39 * 25 + 25 * 39 + 13 * 2   # PI
            + 60 * 25 + 3 * 60 * 25 + 5 * 60 * 25 + 60 * 25         # memory
            + 900 * 25                                               # grid
            + 2 * (104 * 25 + 104 + 1040 + 1040 + 52 + 25 * 52)      # convs
            + 2 * 60 * 25 + 4 * 60 * 25)                             # rules
    assert macs == 65_428
    neurons = 13 * 40 + 4 * 60 + 2 * 104 * 10
    s = slam_counts.step(cfg)
    assert s["neurons"] == neurons == 2_840
    assert s["flops"] == 2 * macs + 10 * neurons == 159_256
    t = dict((n, b) for n, _, b in slam_counts.terms(cfg))
    assert t["cleanup.scores"] == 900 * 25 * 2           # bfloat16
    assert t["voja.update"] == 2 * 60 * 25 * 4           # read and write
    assert t["pes.update"] == 2 * 60 * 25 * 4
    # a learned leaf's bytes are its update's; element-wise maps read no
    # table
    assert t["memory.encoders"] == t["memory.pes_decode"] == 0
    assert t["cc1.align"] == t["cc1.fold"] == t["cc2.align"] == 0
    assert t["cc1.dft_in"] == 2 * 52 * 25 * 4
    assert s["bytes"] == sum(t.values()) + 2 * 2 * neurons * 4


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.slam, "
            "benchmark.reference.slam_check, benchmark.harness.slam_counts; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "sspslam_tpu",
                       "sspslam_tpu_torch"}, tops
