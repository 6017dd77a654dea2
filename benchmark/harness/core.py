"""Cells, configurations, mixes and readers found by name; spans; the
result line."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"

#: top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "sspslam_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def process_start_time() -> float:
    """This process's start on the ``time.time()`` clock: its start time
    in /proc (clock ticks after boot) against the boot-time clock."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.time() - age
    except (OSError, ValueError, AttributeError):
        return time.time()


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str, root: Path = ROOT):
    """(cell, configuration entry, configuration file, mix file) of the
    workload ``workload``."""
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    cfg = load_json(root / conf["file"])
    mix = load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    return cell, conf, cfg, mix


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (a reader named after
    its metric)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(name: str):
    return load_module(BENCH / "entries" / f"{name}.py", f"bench_entry_{name}")


def reader(metric: str):
    return load_module(BENCH / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_"))


def metrics_of(bench: dict, workload: str, kind: str):
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell reports:
    those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the JAX
    package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_info(device_index: int = 0) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device_index),
             "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
        name, limit, clock = (s.strip() for s in
                              out.strip().splitlines()[0].split(","))
        return {"smi_name": name, "power_limit": limit, "sm_clock": clock}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"smi_name": None, "power_limit": None, "sm_clock": None}


class Spans:
    """The harness's spans around its calls into the program's layers:
    (name, start, end) on the host clock, and, while a profiler records,
    ``torch.profiler.record_function`` ranges of the same names, so the
    trace's idle gaps can be named by the span open at the time."""

    def __init__(self):
        self.records = []
        self.profiling = False

    def span(self, name: str):
        return _Span(self, name)

    def total(self, name: str) -> float:
        return sum(b - a for n, a, b in self.records if n == name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name, self.rf = spans, name, None

    def __enter__(self):
        if self.spans.profiling:
            import torch
            self.rf = torch.profiler.record_function("bench." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.spans.records.append((self.name, self.t0, t1))
        return False
