"""The port's benchmark entry point (``python -m sspslam_tpu_torch.bench``)
and its device-time and roofline probes on the CPU, at the toy widths of
tests/test_experiments.py's bench smoke (ssp_dim 31, 60 per VCO, memory
80, 30 per convolution dimension, 10 clean-up samples per dimension, a
2 s world).

Held against the JAX package's ``bench.py`` (loaded by importlib):
- ``build``'s world: the path bit for bit, and the velocities and vectors
  to the landmarks its input adapter receives bit for bit (so the
  landmarks are the same); the tabulated input tables within 1e-6; equal
  FLOPs per step and neuron counts (integer counts of the built shapes);
  the PI output probe over 300 steps within three of
  tests/torch_parity.py's spike-flip bounds (median < atol, q80 < 5 atol,
  peak < 0.25; both packages' clean-up argmax in float32).  The other two
  (under 10 % of steps above 5 atol, runs of them at most 9 steps) do not
  hold on this world: one neuron's voltage lies 1.1e-6 under threshold at
  step 101 in JAX and spikes in the port, the oscillators' phases part
  from there, and the probe differs by 2.8e-3 to 8.1e-3 over the last 45
  steps (32 steps above 5 atol, the longest run 19).  The JAX package's
  own configurations (scan unroll 8 or 1, segments of 300 or 50, a jitted
  step per step) agree with one another to 1.8e-7 over these steps.
- ``main``'s JSON line: ``bench.py``'s keys, less ``tunnel_fallback``, plus
  the card's name and power limit and the port's device-profile keys.
Held within the port: ``--model pi-fast`` on the CPU runs the plain
version and its trace equals ``FastPathIntegrator.run`` on the same
velocities bit for bit; the roofline's bytes are the built leaves' bytes
(a parameter leaf once, a state leaf twice) and its bounds the formula's
(exact arithmetic on the same numbers); the probes measure nothing on the
CPU and a trace without a CUDA kernel raises; without a CUDA device and
without ``--device cpu`` every entry point exits nonzero.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch_parity import SPIKE_ATOL, leaves

import sspslam_tpu.models as jmodels
from sspslam_tpu.utils.profiling import \
    model_utilization_summary as jax_summary

import sspslam_tpu_torch.models as pmodels
from sspslam_tpu_torch import bench
from sspslam_tpu_torch.experiments import device_time_probe, step_roofline
from sspslam_tpu_torch.experiments.common import slam_simulator, slam_world
from sspslam_tpu_torch.models import FastPathIntegrator
from sspslam_tpu_torch.utils.profiling import model_utilization_summary

REPO = Path(__file__).resolve().parents[1]
TOY = ["--ssp-dim", "31", "--pi-n-neurons", "60", "--mem-n-neurons", "80",
       "--circonv-n-neurons", "30", "--cleanup-samples", "10",
       "--world-T", "2"]
CPU = ["--device", "cpu", *TOY]
TABLE_TOL = 1e-6
PI_STEPS = 300
# bench.py:621-660's keys
JAX_KEYS = {"metric", "value", "unit", "platform", "tunnel_fallback",
            "vs_baseline", "baseline_steps_per_s", "device_us_per_step",
            "device_time_ratio", "rep_range", "n_reps", "flops_per_step",
            "mfu", "tracking_cosine", "accuracy_gate", "accuracy_pass",
            "scaled"}
# the port's: the card beside every number, the profiler's view of the
# step, the TF32 setting and the VCO kernel's launches
PORT_KEYS = {"device_name", "power_limit_w", "kernels_per_step",
             "device_busy_share", "allow_tf32", "vco_scan_launches"}
BATCH_KEYS = {"B", "agg_steps_per_s", "us_per_iteration",
              "us_per_episode_step", "mfu", "rep_range"}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Float32 clean-up argmax in both packages; the port's small ops run
    fastest on one thread."""
    monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def jax_bench():
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recorded(monkeypatch, module):
    """Record the (velocities, vectors to the landmarks) that ``module``'s
    ``get_slam_input_functions`` is called with."""
    calls = []
    real = module.get_slam_input_functions

    def record(space, lm_space, vels, vec, *a, **k):
        calls.append((np.array(vels), np.array(vec)))
        return real(space, lm_space, vels, vec, *a, **k)
    monkeypatch.setattr(module, "get_slam_input_functions", record)
    return calls


def run_main(capsys, argv):
    """``bench.main(argv)``: its row and the JSON lines it printed."""
    row = bench.main(argv)
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.startswith("{")]
    return row, lines


def test_build_matches_jax_bench(monkeypatch):
    jcalls = recorded(monkeypatch, jmodels)
    pcalls = recorded(monkeypatch, pmodels)
    jargs = argparse.Namespace(
        ssp_dim=31, pi_n_neurons=60, mem_n_neurons=80, circonv_n_neurons=30,
        n_landmarks=10, cleanup_samples=10, seed=0, scan_unroll=8,
        bf16=False, world_T=2.0)
    jsim, jprobe, _, jpath = jax_bench().build(jargs)
    psim, pprobe, _, ppath = bench.build(bench.parse_args(CPU))

    np.testing.assert_array_equal(ppath, jpath)
    assert len(jcalls) == len(pcalls) == 1
    for got, want in zip(pcalls[0], jcalls[0]):
        np.testing.assert_array_equal(got, want)
    n = len(jpath)
    jtabs = jsim._tabulate_inputs(n)
    ptabs = psim._tabulate_inputs(n)
    assert len(jtabs) == len(ptabs) == 5
    for got, want in zip(ptabs, jtabs):
        want = np.asarray(want, np.float32).reshape(n, -1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TABLE_TOL, rtol=0)
    assert bench.model_flops_per_step(psim.model) == float(
        sum(r["flops_per_step"] for r in jax_summary(jsim.model)))
    assert bench.n_neurons(psim.model) == sum(
        (be.k * be.n if be.batched else be.n)
        for be in jsim.model.ensembles)

    jsim.run_steps(PI_STEPS, segment_steps=PI_STEPS)
    psim.run_steps(PI_STEPS, segment_steps=PI_STEPS)
    want = np.asarray(jsim.data[jprobe], np.float64)
    got = psim.data[pprobe]
    assert got.shape == want.shape and want.shape[0] == PI_STEPS
    per_t = np.abs(got - want).max(axis=1) / max(np.abs(want).max(), 1.0)
    assert np.median(per_t) < SPIKE_ATOL
    assert np.quantile(per_t, 0.8) < 5 * SPIKE_ATOL
    assert per_t.max() < 0.25


def test_main_slam_prints_bench_keys(capsys):
    row, lines = run_main(capsys, [
        *CPU, "--segment-steps", "500", "--timed-steps", "1000", "--reps",
        "2", "--baseline-steps", "30", "--baseline-reps", "2"])
    assert lines == [row]
    assert set(row) == JAX_KEYS - {"tunnel_fallback"} | PORT_KEYS
    assert row["unit"] == "steps/s" and row["value"] > 0
    assert np.isfinite(row["tracking_cosine"])
    assert row["accuracy_pass"] == (row["tracking_cosine"] >= 0.93)
    assert row["platform"] == "cpu" and row["power_limit_w"] is None
    # nothing on the CPU is a device number
    assert row["device_us_per_step"] is None and row["mfu"] > 0
    assert row["vs_baseline"] > 0 and row["baseline_steps_per_s"] > 0
    assert row["n_reps"] == 2 and len(row["rep_range"]) == 2
    assert row["scaled"] is None and row["vco_scan_launches"] == 0
    assert row["flops_per_step"] == bench.model_flops_per_step(
        bench.build(bench.parse_args(CPU))[0].model)


@pytest.mark.parametrize("model", ["pi", "pi-fast"])
def test_main_pi_prints_one_row(capsys, model):
    row, lines = run_main(capsys, [*CPU, "--model", model,
                                   "--segment-steps", "100",
                                   "--timed-steps", "200"])
    assert lines == [row]
    assert row["value"] > 0 and row["unit"] == "steps/s"
    assert row["platform"] == "cpu" and row["vs_baseline"] is None


def test_pi_fast_cpu_is_fast_path_integrator():
    """On the CPU ``--model pi-fast`` runs the kernel's plain version and
    launches nothing; its trace is ``FastPathIntegrator.run``'s on the
    same velocities, bit for bit."""
    args = bench.parse_args([*CPU, "--model", "pi-fast", "--segment-steps",
                             "100", "--timed-steps", "200"])
    row, trace = bench.bench_pi(args, fast=True)
    assert row["vco_scan_launches"] == 0
    vels = (0.02 * np.random.default_rng(0).normal(size=(300, 2))).astype(
        np.float32)
    fpi = FastPathIntegrator(bench.make_space(args), 60, seed=0,
                             chunk_steps=100, device="cpu")
    want = fpi.run(vels)
    assert trace.shape == want.shape == (300, fpi.d)
    np.testing.assert_array_equal(trace, want)


def test_batch_sweep_rows(capsys):
    row, lines = run_main(capsys, [*CPU, "--batch-sweep", "1,2",
                                   "--segment-steps", "50",
                                   "--timed-steps", "50", "--reps", "1"])
    assert lines[-1] == row and len(lines) == 3
    assert [r["B"] for r in row["batch_sweep"]] == [1, 2]
    for r in row["batch_sweep"]:
        assert set(r) == BATCH_KEYS
        assert r["agg_steps_per_s"] > 0 and r["mfu"] > 0
        assert r["us_per_iteration"] == pytest.approx(
            r["B"] * r["us_per_episode_step"], rel=1e-12)
    assert row["value"] == row["batch_sweep"][-1]["agg_steps_per_s"]


def tensor_bytes(tree):
    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if torch.is_tensor(x))


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_roofline_counts_leaves(dtype):
    """Bytes: every parameter leaf once and every state leaf twice, at the
    stored dtype (an int8 payload 1 byte an element); bounds: FLOPs over
    67 TFLOP/s and bytes over 3.35 TB/s, the larger binding."""
    space = bench.make_space(bench.parse_args(CPU))
    sim, _, _ = slam_simulator(space, slam_world(2.0, 10, 0), pi_n_neurons=60,
                               mem_n_neurons=80, circonv_n_neurons=30,
                               cleanup_samples=10, matmul_dtype=dtype,
                               device="cpu")
    r = step_roofline.roofline(sim)
    params, state = tensor_bytes(sim.params), tensor_bytes(sim.state)
    assert (r["param_bytes"], r["state_bytes"]) == (params, state)
    assert r["hbm_bytes_per_step"] == params + 2 * state
    flops = float(sum(x["flops_per_step"]
                      for x in model_utilization_summary(sim.model)))
    assert r["flops_per_step"] == flops and r["peak"] == "float32"
    compute = flops / 67e12 * 1e6
    bandwidth = (params + 2 * state) / 3.35e12 * 1e6
    assert r["compute_bound_us"] == compute
    assert r["bandwidth_bound_us"] == bandwidth
    assert r["roofline_us_per_step"] == max(compute, bandwidth)
    assert r["bound_by"] == ("bytes" if bandwidth > compute
                             else "operations")
    assert r["measured_us_per_step"] is None
    assert r["fraction_of_roofline"] is None
    assert step_roofline.roofline(sim, 10.0)["fraction_of_roofline"] == \
        max(compute, bandwidth) / 10.0
    if dtype == "int8":
        one_byte = [x for x in leaves(sim.params)
                    if torch.is_tensor(x) and x.dtype == torch.int8]
        assert one_byte and all(x.element_size() == 1 for x in one_byte)


def test_probes_measure_nothing_on_cpu(capsys):
    out = device_time_probe.main([*CPU, "--steps", "50",
                                  "--segment-steps", "50"])
    assert out["value"] is None and out["platform"] == "cpu"
    roof = step_roofline.main([*CPU, "--steps", "50",
                               "--segment-steps", "50"])
    assert roof["measured_us_per_step"] is None
    assert roof["hbm_bytes_per_step"] > 0
    printed = [json.loads(line)
               for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == [out, roof]
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        device_time_probe.profile_steps(lambda: torch.ones(3).sum(), 1)


@pytest.mark.parametrize("module", [
    "sspslam_tpu_torch.bench",
    "sspslam_tpu_torch.experiments.device_time_probe",
    "sspslam_tpu_torch.experiments.step_roofline"])
def test_no_cpu_fallback(module):
    """With no CUDA device visible and no ``--device cpu``, each entry
    point exits nonzero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", module, *TOY],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "{" not in proc.stdout
