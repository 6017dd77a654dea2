"""Whole runs with the chip check skipped (CPU, tiny widths): a sound run
is correct; the control and each fault a cell can have are not.

The faults are planted underneath the timed path: a step that returns its
state unchanged, a launch that starts from rest instead of the state the
last one carried, an answer altered where it is produced.  (The cell runs
one episode a launch on one chip, so it can leave out neither half of a
batch nor an exchange between chips.)  The card-marked test reads the
control at the cell's own size on the chip.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, tiny
from benchmark.harness import cell, core

BENCH = core.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def run(name, seconds=1.0, seed=2 ** 31 + 41, trace=False):
    c, _, cfg, mix = core.cell_files(BENCH, name)
    cfg, mix = tiny.shrink(cfg, mix)
    torch.set_num_threads(1)
    return cell.run(BENCH, c, cfg, mix, seed=seed, seconds=seconds,
                    trace=trace, device=torch.device("cpu"),
                    t_start=time.time())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, trace):
    # a traced window runs on past its slice, for the rate mfu reads
    r = run(name, seconds=8.0 if trace else 1.0, trace=trace)
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared"
    kind = "per_layer" if trace else "end_to_end"
    m = {x["name"] for x in core.metrics_of(BENCH, name, kind)}
    if trace:
        # the CPU's trace holds no device record: the device's readers
        # find nothing and their metrics are left out
        assert set(r["metrics"]) == m - {"vco_scan_roofline",
                                         "device_idle_share"}
        assert r["device"]["busy_s"] == 0.0
    else:
        assert set(r["metrics"]) == m


def _fast_unchanged(monkeypatch):
    from sspslam_tpu_torch.models import fast_pathint
    from sspslam_tpu_torch.ops import vco_scan as vs

    def frozen_scan(params, state, vel, corr):
        rows = [state.fout] * vel.shape[0]
        return state, torch.cat(rows) @ vs.output_projection(params)
    monkeypatch.setattr(fast_pathint, "vco_scan", frozen_scan)


def _fast_restart(monkeypatch):
    from sspslam_tpu_torch.models import fast_pathint
    from sspslam_tpu_torch.ops import vco_scan as vs
    scan = fast_pathint.vco_scan

    def from_rest(params, state, vel, corr):
        n, k = params.bias.shape
        return scan(params, vs.initial_vco_state(n, k, device=vel.device),
                    vel, corr)
    monkeypatch.setattr(fast_pathint, "vco_scan", from_rest)


def _fast_altered(monkeypatch):
    from sspslam_tpu_torch.models import fast_pathint
    scan = fast_pathint.vco_scan

    def altered(params, state, vel, corr):
        s, y = scan(params, state, vel, corr)
        return s, y + 1e-3
    monkeypatch.setattr(fast_pathint, "vco_scan", altered)


FAULTS = [
    ("pi-d97.fast", "unchanged", _fast_unchanged),
    ("pi-d97.fast", "restart", _fast_restart),
    ("pi-d97.fast", "altered", _fast_altered),
]


@pytest.mark.parametrize("name,fault,plant", FAULTS,
                         ids=[f"{n}-{f}" for n, f, _ in FAULTS])
def test_fault_is_not_correct(name, fault, plant, monkeypatch):
    plant(monkeypatch)
    r = run(name)
    assert not r["correct"], (fault, r["compared"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference at TF32 in the program's place fails a limit (tiny
    widths on the CPU)."""
    c, _, cfg, mix = core.cell_files(BENCH, name)
    cfg, mix = tiny.shrink(cfg, mix)
    torch.set_num_threads(1)
    r = control.readings(name, 2 ** 31 + 43, 1.0, torch.device("cpu"),
                         cfg, mix, BENCH)
    lim = mix["limits"]
    assert all(r["program"][k] <= lim[k] for k in lim), r
    assert any(r["control"][k] > lim[k] for k in lim), r


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_on_the_card(name):
    """The control at the cell's own size on three seeds: each reading of
    the program within every limit, each of the control's over one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    lim = core.cell_files(BENCH, name)[3]["limits"]
    for seed in (101, 102, 103):
        r = control.readings(name, seed, 3.0, torch.device("cuda", 0))
        assert all(r["program"][k] <= lim[k] for k in lim), r
        assert any(r["control"][k] > lim[k] for k in lim), r
