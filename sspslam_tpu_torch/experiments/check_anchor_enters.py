"""Veridicality check of the anchor runs' recovery enters on the port: the
flags and printed lines of the JAX package's
``experiments/check_anchor_enters.py``, with ``--device`` (default
``cuda``) in place of ``--cpu``.

An in-model recovery enter before the kidnap counts as a "false trigger";
the anchor statistic is cos(pi (x) anchor_vec, anchor_pos) = K(true pose
error), so an enter is veridical iff the adaptive model's TRUE decoded
pose error at that instant exceeded the detection bound (about the view
radius).  This reads ``kidnapped_robot --dump``'s npz (the adaptive PI
trace and the true path) and prints the decoded error around each queried
enter time, with no re-simulation.

    python -m sspslam_tpu_torch.experiments.check_anchor_enters dump.npz \
        --seed 0 --length-scale 0.2 --enters 92.0 [...] [--device cpu]
"""

import argparse

import numpy as np

from ..sspspace import HexagonalSSPSpace
from .common import decode_output


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("npz")
    ap.add_argument("--seed", type=int, required=True,
                    help="the run's --seed (the space is seed-dependent)")
    ap.add_argument("--length-scale", type=float, default=0.2)
    ap.add_argument("--enters", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode (cuda | cpu)")
    args = ap.parse_args(argv)
    z = np.load(args.npz)
    pi, path, sk, dt = z["pi"], z["path"], int(z["skip"]), float(z["dt"])
    dim = path.shape[1]
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (dim, 1))
    space = HexagonalSSPSpace(dim, ssp_dim=pi.shape[1], seed=args.seed,
                              length_scale=args.length_scale,
                              domain_bounds=bounds)
    t = dt * sk * np.arange(len(pi))
    rows = []
    for te in args.enters:
        lo, hi = np.searchsorted(t, [te - 2.0, te + 2.0])
        est = decode_output(space, pi[lo:hi], dim, grid=100,
                            device=args.device)
        err = np.linalg.norm(path[lo:hi] - est, axis=1)
        at = min(int(np.searchsorted(t[lo:hi], te)), len(err) - 1)
        print(f"enter t={te:.1f}s: err(at)={err[at]:.3f} "
              f"max(+/-2s)={err.max():.3f} median(+/-2s)={np.median(err):.3f}")
        rows.append((float(err[at]), float(err.max()),
                     float(np.median(err))))
    return rows


if __name__ == "__main__":
    main()
