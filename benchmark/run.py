"""The benchmark of the PyTorch / CUDA port (``sspslam_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, its traffic mix (``benchmark/traffic/<mix>.json``), the
mix's entry (``benchmark/entries/<entry>.py``) and each per-layer metric's
reader (``benchmark/metrics/<metric>.py``).  A run builds the cell's
network from the seed and warms up (set-up), drives the program for
``--seconds`` (the window), then holds what the timed path produced to the
plain reference (``benchmark/reference``).  The last line of standard
output is the result: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics read from a traced slice of the
window.  Without as many CUDA devices as the cell asks for it prints no
result and exits 2.
"""

from __future__ import annotations

import os
import sys

# One process with few threads: the host's BLAS and OpenMP pools would
# spin on the cores the launching thread needs.
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_v] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import core  # noqa: E402


def parse(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root) -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths (the VCO kernel builds into ``build/torch_kernels`` there
    by itself)."""
    cache = os.path.join(root, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    args = parse(argv)
    t_start = core.process_start_time()
    root = core.ROOT
    cache_dirs(str(root))
    bench = core.load_benchmark(root)
    cell, conf, cfg, mix = core.cell_files(bench, args.workload, root)
    import torch
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        core.log(f"{args.workload} needs {need} CUDA device(s); "
                 f"available: {torch.cuda.is_available()}, count "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from benchmark.harness import cell as cell_run
    result = cell_run.run(bench, cell, cfg, mix, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=torch.device("cuda", 0), t_start=t_start)
    bad = core.forbidden_modules()
    if bad:
        core.log(f"forbidden modules loaded in this process: {bad}")
        return 3
    cell_run.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
