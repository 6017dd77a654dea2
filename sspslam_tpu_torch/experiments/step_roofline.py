"""Roofline of the bench SLAM step beside its measured device time.

Port of the JAX package's ``experiments/step_roofline.py`` for the H100.
The JAX tool read XLA's cost analysis; this one counts from the built
shapes:

- FLOPs per step: ``utils.profiling.model_utilization_summary``'s total
  (the encoders' and decoders' matrix-vector products, 2 per
  multiply-add);
- bytes per step: every parameter leaf read once, every state leaf read
  once and written once, at its stored dtype (an int8 or fp8 payload
  counts 1 byte an element, its float32 scales 4);
- the compute bound: FLOPs over 67 TFLOP/s (the H100 SXM's float32 peak
  outside the tensor cores), or over 495 TFLOP/s (TF32) when
  ``torch.backends.cuda.matmul.allow_tf32`` is on; the bandwidth bound:
  bytes over 3.35 TB/s (HBM3); the step bound: the larger, named in
  ``bound_by``.

It builds ``bench.py --model slam``'s model (``sspslam_tpu_torch.bench``)
and, on a CUDA device, puts the bound beside the profiler's device time
per step (:mod:`.device_time_probe`); on ``--device cpu`` the measured
time is None ("not measured").  Peaks are NVIDIA's data-sheet figures at
700 W; the card's power limit is printed beside them.

    python -m sspslam_tpu_torch.experiments.step_roofline [--steps 2000]

Prints one JSON line.  Not carried: the TPU defaults ``--peak-flops
99e12`` and ``--peak-bw 819e9``, ``--scan-unroll`` and ``--seg`` (XLA's
cost analysis of an unrolled scan); ``--measured-us`` (the tool measures).
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import bench
from ..nef.simulator import _flatten
from .device_time_probe import SEGMENT, STEPS, measure_device_time, \
    warmed_bench_model

#: NVIDIA H100 SXM data-sheet peaks (dense, 700 W): float32 outside the
#: tensor cores and TF32 on them; HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12}
PEAK_BYTES_PER_S = 3.35e12


def leaf_bytes(tree) -> int:
    """Bytes of a params or state tree's tensor leaves at their stored
    dtype (a QTensor's payload and its scales)."""
    return sum(x.numel() * x.element_size() for x in _flatten(tree)
               if torch.is_tensor(x))


def roofline(sim, measured_us=None) -> dict:
    """The step's FLOPs and bytes, its compute, bandwidth and step bounds
    in us, which of the two bounds it, and (given ``measured_us``, the
    device us per step) the bound's share of the measured time."""
    flops = bench.model_flops_per_step(sim.model)
    param_bytes = leaf_bytes(sim.params)
    state_bytes = leaf_bytes(sim.state)
    hbm_bytes = param_bytes + 2 * state_bytes
    peak = ("tf32" if sim.device.type == "cuda"
            and torch.backends.cuda.matmul.allow_tf32 else "float32")
    compute_us = flops / PEAK_FLOPS[peak] * 1e6
    bandwidth_us = hbm_bytes / PEAK_BYTES_PER_S * 1e6
    roof_us = max(compute_us, bandwidth_us)
    return {
        "flops_per_step": flops,
        "param_bytes": param_bytes,
        "state_bytes": state_bytes,
        "hbm_bytes_per_step": hbm_bytes,
        "peak": peak,
        "peak_flops": PEAK_FLOPS[peak],
        "peak_bytes_per_s": PEAK_BYTES_PER_S,
        "compute_bound_us": compute_us,
        "bandwidth_bound_us": bandwidth_us,
        "roofline_us_per_step": roof_us,
        "bound_by": "operations" if compute_us >= bandwidth_us else "bytes",
        "measured_us_per_step": measured_us,
        "fraction_of_roofline": (None if measured_us is None
                                 else roof_us / measured_us),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    bench.add_model_args(ap)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="steps the device time is measured over")
    ap.add_argument("--segment-steps", type=int, default=SEGMENT)
    args = ap.parse_args(argv)

    sim = warmed_bench_model(args, args.steps)
    prof = measure_device_time(sim, args.steps, args.segment_steps)
    report = roofline(sim, None if prof is None
                      else prof["device_us_per_step"])
    report.update(bench.card(sim.device))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
