"""Offline re-decode of a saved ``scaled_slam --save`` npz on the port:
how much of the tracking error is the READOUT's (grid quantisation)
rather than the model's.  The flags and JSON lines of the JAX package's
``experiments/redecode_scaled.py``, with ``--device`` (default ``cuda``)
in place of ``--cpu``.

The npz holds the probed SSP outputs and the true paths; re-decoding
them with the batched Newton polish (``direct-optim``) beside the 30 per
axis grid argmax separates the decode floor from the model error without
re-simulating.

    python -m sspslam_tpu_torch.experiments.redecode_scaled \
        data/scaled_slam_*.npz [--grid 30] [--device cpu]

Prints one JSON line per seed and one per file.
"""

import argparse
import json
import os

import numpy as np

from ..sspspace import HexagonalSSPSpace


def redecode(fn, grid=30, device="cuda"):
    with np.load(fn, allow_pickle=True) as f:
        meta = json.loads(str(f["meta"][0]))
        slam_out = f["slam_out"]          # (B, samples, d)
        pi_out = f["pi_out"]
        paths = f["paths"]                # (B, n_steps, dim)
    cfg = meta["config"]
    dim = cfg["domain_dim"]
    seeds = [r["seed"] for r in meta["per_seed"]]
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (dim, 1))
    space = HexagonalSSPSpace(dim, ssp_dim=cfg["ssp_dim"], seed=seeds[0],
                              length_scale=cfg.get("length_scale", 0.3),
                              domain_bounds=bounds)
    assert space.ssp_dim == cfg["ssp_dim"], (space.ssp_dim, cfg["ssp_dim"])

    B, k, _ = slam_out.shape
    per = paths.shape[1] // k
    rows = []
    for b in range(B):
        path_s = paths[b][per - 1::per][:k]
        entry = {"seed": seeds[b]}
        for name, out in (("slam", slam_out),
                          ("pi_only", pi_out if pi_out.size else None)):
            if out is None:
                continue
            for method in ("from-set", "direct-optim"):
                est = space.decode(out[b], method, "grid", grid,
                                   device=device)
                err = np.sqrt(np.sum((path_s - est) ** 2, axis=1))
                half = err[len(err) // 2:]
                key = "grid" if method == "from-set" else "polished"
                entry.setdefault(name, {})[key] = round(
                    float(np.median(half)), 4)
        rows.append(entry)
        print(json.dumps(entry), flush=True)
    med_g = float(np.median([r["slam"]["grid"] for r in rows]))
    med_p = float(np.median([r["slam"]["polished"] for r in rows]))
    out_line = {
        "file": os.path.basename(fn),
        "metric": "scaled re-decode: grid argmax vs Newton-polished "
                  "readout (same probed outputs)",
        "median_grid": round(med_g, 4),
        "median_polished": round(med_p, 4),
        "decode_floor_removed": round(med_g - med_p, 4),
        "per_seed": rows,
    }
    print(json.dumps(out_line))
    return out_line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="+")
    ap.add_argument("--grid", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode (cuda | cpu)")
    a = ap.parse_args(argv)
    return [redecode(fn, grid=a.grid, device=a.device) for fn in a.files]


if __name__ == "__main__":
    main()
