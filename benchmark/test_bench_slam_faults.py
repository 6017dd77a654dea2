"""The SLAM cell's whole runs at tiny widths on the CPU: a sound run is
correct; the control and each planted fault are not.

The faults are planted underneath the timed path, in the program: PES
learning down the error's wrong side, Voja's encoders frozen, the
correction gate held shut, the clean-up scored in float16 where bfloat16
is stated, the position estimate's convolution left uninverted.  The
card-marked test reads the control and the faults at the cell's own size
on the chip.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, tiny_slam
from benchmark.harness import cell, core

BENCH = core.load_benchmark()
NAME = "slam-d97.b1"


def run(seed=2 ** 31 + 41, seconds=2.5, device="cpu", size=tiny_slam.shrink):
    c, _, cfg, mix = core.cell_files(BENCH, NAME)
    cfg, mix = size(cfg, mix)
    torch.set_num_threads(1)
    return cell.run(BENCH, c, cfg, mix, seed=seed, seconds=seconds,
                    trace=False, device=torch.device(device),
                    t_start=time.time())


def _pes_flipped(mp):
    from sspslam_tpu_torch.ops import learning
    update = learning.pes_update

    def flipped(decoders, activities, error, lr, dt, n_neurons=None):
        return update(decoders, activities, -error, lr, dt, n_neurons)
    mp.setattr(learning, "pes_update", flipped)


def _voja_off(mp):
    from sspslam_tpu_torch.ops import learning
    mp.setattr(learning, "voja_update",
               lambda scaled_encoders, *a, **k: scaled_encoders)


def _gate_shut(mp):
    from sspslam_tpu_torch.models import slam
    make = slam.make_update_state_func

    def shut(update_thres, shift_rate, d):
        f = make(update_thres, shift_rate, d)

        def closed(t, x, consts=None):
            return 0.0 * f(t, x, consts)
        closed.hoisted_consts = f.hoisted_consts
        return closed
    mp.setattr(slam, "make_update_state_func", shut)


def _cleanup_fp16(mp):
    from sspslam_tpu_torch.ops import vsa
    mp.setattr(vsa, "default_cleanup_dtype", lambda: torch.float16)


def _uninverted(mp):
    from sspslam_tpu_torch.models import slam
    cc = slam.CircularConvolution

    class Uninverted(cc):
        def __init__(self, *a, invert_a=False, **k):
            super().__init__(*a, invert_a=False, **k)
    mp.setattr(slam, "CircularConvolution", Uninverted)


FAULTS = {"pes_flipped": _pes_flipped, "voja_off": _voja_off,
          "gate_shut": _gate_shut, "cleanup_fp16": _cleanup_fp16,
          "uninverted": _uninverted}


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["compared"]
    assert r["attempted"] >= tiny_slam.MIX["check_within"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run()
    assert not r["correct"], (fault, r["compared"])


def test_control_is_not_correct():
    c, _, cfg, mix = core.cell_files(BENCH, NAME)
    cfg, mix = tiny_slam.shrink(cfg, mix)
    torch.set_num_threads(1)
    r = control.readings(NAME, 2 ** 31 + 43, 2.5, torch.device("cpu"),
                         cfg, mix, BENCH)
    lim = mix["limits"]
    assert all(r["program"][k] <= lim[k] for k in lim), r
    assert any(r["control"][k] > lim[k] for k in lim), r


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_on_the_card(fault, monkeypatch):
    """Each planted fault at the cell's own size on the chip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    FAULTS[fault](monkeypatch)
    r = run(seed=2 ** 31 + 1007, seconds=25.0, device="cuda",
            size=lambda cfg, mix: (cfg, mix))
    assert not r["correct"], (fault, r["compared"])
