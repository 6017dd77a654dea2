"""Tracking of SLAMNetwork on the card per parameter storage, over eight
worlds: bench.py --model slam's figure-eight path with eight landmark
layouts (layout b drawn from seed b; layout 0 is bench.py's own), run as
one batch of episodes (``parallel.BatchedEpisodes``) at phase 11's full
width of ``chip_smoke.py``, for float32, bf16, int8 and fp8.

    python3 tests/torch_dtype_tracking.py      # from the repository root

Needs a CUDA device; imports nothing of JAX.  Prints, per storage, the
tracking cosine of each world (the mean over the last quarter of the 14 s
world of cos(PI output, encode(path)), as bench.py computes it), then one
JSON line.  It shows how far one world's cosine moves with rounding alone,
against which ``chip_smoke.py`` phase 19 sets its int8 band.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

WORLDS = 8


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_dtype_tracking: no CUDA device")
    from sspslam_tpu_torch import HexagonalSSPSpace
    from sspslam_tpu_torch.parallel import BatchedEpisodes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    space = cs.make_space(HexagonalSSPSpace)
    world = cs.slam_world()
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi()}
    for dtype in ("f32", "bf16", "int8", "fp8"):
        sim, probe, _ = cs.slam_simulator(
            space, world, matmul_dtype=None if dtype == "f32" else dtype)
        pi = next(bp.index for bp in sim.model.probes if bp.obj is probe)
        runner = BatchedEpisodes(sim, cs.episode_tables(sim, space, WORLDS))
        trace = runner.run(cs.WORLD_STEPS)[pi].cpu().numpy()
        cos = [cs.tracking_cosine(space, trace[:, b], world[0])
               for b in range(WORLDS)]
        out[dtype] = cos
        cs.log(f"{dtype}: tracking over {WORLDS} worlds "
               f"{np.round(cos, 4).tolist()}, mean {np.mean(cos):.4f}")
        del sim, runner
    print(json.dumps(out))


if __name__ == "__main__":
    main()
