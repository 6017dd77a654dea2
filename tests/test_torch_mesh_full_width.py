"""The port's sharded SLAM at full width, and the multi-rank entry points,
on gloo ranks on the CPU.

- bench.py's seed-0 world at full width (82,280 LIF), sharded over 2
  ranks for 300 steps: the first 300 probe rows against the JAX
  package's (tests/reference/full_width_jax.npz) by ``chip_smoke.
  check_first_rows``, the bounds the unsharded CPU build is held to
  (tests/test_torch_full_width_reference.py), the same rows on both
  ranks, and at most 8 all-reduces a step.
- ``python -m sspslam_tpu_torch.parallel.dryrun --world 4 --device cpu``
  exits 0: the sharded SLAM steps, the per-rank FLOP ratio under 3.0,
  its serving bundle served on the ranks (one program a rank), the
  data-parallel fit moving its leaves, dp x tp episodes.
- ``python -m sspslam_tpu_torch.experiments.tp_scaling --device cpu`` at
  toy widths over 1 and 2 ranks: a row a size, the per-rank FLOPs under
  the one-rank build's, collectives only when sharded; asking for more
  CUDA ranks than cards raises.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_mesh_ranks as R
from torch_parity import spawn_ranks

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

REFERENCE = REPO / "tests" / "reference" / "full_width_jax.npz"


def test_full_width_world_two_meets_first_rows(tmp_path):
    ranks = spawn_ranks(R.run_full_width, 2, tmp_path, timeout=400,
                        args=(chip_smoke.REFERENCE_ROWS,))
    (trace, stats), (other, _) = ranks
    assert np.array_equal(trace, other)
    assert trace.shape == (chip_smoke.REFERENCE_ROWS, 97)
    with np.load(REFERENCE) as f:
        want = f["slam_s0_rows300"]
    chip_smoke.check_first_rows(trace, want,
                                "the port's SLAM sharded over 2 ranks")
    assert 1 <= stats["all_reduces"] <= 8, stats


def _run(args, timeout=300):
    import os
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m"] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_dryrun_cli_world_four_on_cpu():
    out = _run(["sspslam_tpu_torch.parallel.dryrun", "--world", "4",
                "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-3000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["world"] == 4 and row["rows"] == [16, 25]
    assert row["flops_ratio_to_ideal"] < 3.0
    assert 1 <= row["all_reduces_per_step"] <= 8
    assert row["dp_tp_rows"] == [2, 8, 25]
    # the bundle step: one program a model coordinate, each with the
    # live step's all-reduces, one served segment of 4 rows
    assert row["bundle"] == {"programs": 4, "all_reduces_per_step":
                             row["all_reduces_per_step"], "rows": [4, 25]}


def test_tp_scaling_cli_on_cpu():
    out = _run(["sspslam_tpu_torch.experiments.tp_scaling", "--device",
                "cpu", "--mesh-sizes", "1,2", "--steps", "10", "--reps",
                "1", "--ssp-dim", "31", "--pi-n-neurons", "40",
                "--mem-n-neurons", "60", "--circonv-n-neurons", "10"])
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [r["mesh"] for r in rows] == [1, 2]
    assert rows[0]["all_reduces_per_step"] == 0
    assert rows[1]["all_reduces_per_step"] >= 1
    assert rows[1]["flops_per_rank"] < rows[0]["flops_per_rank"]
    assert all(r["median_ms_per_segment"] > 0 for r in rows)


def test_tp_scaling_refuses_more_cuda_ranks_than_cards():
    from sspslam_tpu_torch.experiments import tp_scaling
    with pytest.raises(RuntimeError, match="cards"):
        tp_scaling.main(["--mesh-sizes", "1,2"])
