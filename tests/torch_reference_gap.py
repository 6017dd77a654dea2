"""Where the card's full-width SLAM run parts from the CPU's and from JAX's.

    python3 tests/torch_reference_gap.py

Builds ``bench.py``'s seed-0 world (``sspslam_tpu_torch.bench.build`` at
its defaults) on one CUDA card (TF32 off) and on the host's CPU, and steps
it REFERENCE_ROWS steps four ways: each build's parameters stepped on
each device.  Prints:

- each build's parameters against the other's: the leaves that differ and
  the largest relative difference of each (the float32 decoder solves run
  on each device), and each build's worst relative checksum error against
  the JAX build's (``chip_smoke.check_leaf_sums``);
- the same build on the CPU with its float32 device solves run in
  float64 (``solvers._f32`` patched): the card's and the CPU's
  device-solved leaves against it, and its trace against JAX's;
- each of the traces against the JAX reference's first rows
  (``tests/reference/full_width_jax.npz``, ``slam_s0_rows300``) by
  ``chip_smoke.spike_flip_stats``;
- the card's parameters stepped on both devices, one step at a time: the
  probe rows' largest difference, and for each neuron population the
  first step at which a neuron spikes on one side and not on the other,
  the largest voltage difference before it and the number of such
  neurons in the first SHOWN steps and in the last.

The last line is one JSON object with these numbers, the card's name and
its power limit.  Exits 1 without a card.  Imports nothing of JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

STEPS = chip_smoke.REFERENCE_ROWS
SHOWN = 12          # the first steps whose numbers are printed
CPU_THREADS = 8


def to_device(tree, device):
    """A parameter tree with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device) if hasattr(tree, "to") else tree


def build(device, solve_dtype=torch.float32):
    """bench.py's seed-0 world on ``device``, its device-solved decoders
    solved in ``solve_dtype``."""
    from sspslam_tpu_torch import bench
    from sspslam_tpu_torch.nef import solvers
    f32 = solvers._f32
    solvers._f32 = lambda x, device: torch.as_tensor(
        np.asarray(x), dtype=solve_dtype, device=device)
    try:
        sim, probe, _, _ = bench.build(bench.parse_args(["--device", device]))
    finally:
        solvers._f32 = f32
    return sim, probe


def param_diffs(a, b):
    """{leaf path: largest |a - b| / max |b|} of the leaves that differ."""
    out = {}
    other = dict(chip_smoke.flat_leaves(b))
    for path, x in chip_smoke.flat_leaves(a):
        x = np.asarray(x.detach().cpu().to(torch.float64))
        y = np.asarray(other[path].detach().cpu().to(torch.float64))
        d = float(np.max(np.abs(x - y), initial=0.0))
        if d > 0:
            out[path] = d / max(float(np.max(np.abs(y))), 1e-30)
    return out


def neurons(sim):
    """{population: (voltage, refractory)} of the simulator's neurons, on
    the host."""
    leaves = dict(chip_smoke.flat_leaves(sim.state))
    pops = sorted({p.rsplit("/", 1)[0] for p in leaves
                   if p.startswith("neurons/")})
    return {p: (leaves[p + "/voltage"].cpu().numpy().copy(),
                leaves[p + "/refractory"].cpu().numpy().copy())
            for p in pops}


def stepwise(card, host):
    """The same parameters stepped on the card and the CPU one step at a
    time.  A neuron spiked in a step when its refractory time rose (it
    falls by dt a step otherwise).  Per population: the step of the first
    spike that one side fired and the other did not, the number of such
    neurons in each of the first SHOWN steps and in the last step, and the
    largest voltage |diff| before the first.  Returns those, the probe
    rows' largest |diff| in the first SHOWN steps, and the two traces."""
    (sim_g, probe_g), (sim_c, probe_c) = card, host
    dt = sim_g.dt
    prev_g, prev_c = neurons(sim_g), neurons(sim_c)
    pops = {p: {"flips": [], "voltage": []} for p in prev_g}
    for _ in range(STEPS):
        sim_g.run_steps(1)
        sim_c.run_steps(1)
        now_g, now_c = neurons(sim_g), neurons(sim_c)
        for p, r in pops.items():
            spiked_g = now_g[p][1] > prev_g[p][1] - dt / 2
            spiked_c = now_c[p][1] > prev_c[p][1] - dt / 2
            r["flips"].append(int(np.sum(spiked_g != spiked_c)))
            r["voltage"].append(float(np.max(np.abs(now_g[p][0] -
                                                    now_c[p][0]))))
        prev_g, prev_c = now_g, now_c
    g, c = sim_g.data[probe_g], sim_c.data[probe_c]
    out = {}
    for p, r in pops.items():
        first = next((t for t, n in enumerate(r["flips"]) if n), None)
        out[p] = {"n_neurons": int(prev_g[p][0].size),
                  "first_spike_flip_step": first,
                  "flips_first_steps": r["flips"][:SHOWN],
                  "flips_last_step": r["flips"][-1],
                  "voltage_max_diff_before_first_flip": max(
                      r["voltage"][:first] if first else [0.0])}
    rows = np.max(np.abs(g - c), axis=1)
    return {"populations": out,
            "probe_row_max_abs_first_steps": rows[:SHOWN].tolist(),
            "probe_row_max_abs_largest": float(rows.max())}, g, c


def main():
    if not torch.cuda.is_available():
        print("torch_reference_gap: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(CPU_THREADS)
    ref = chip_smoke.load_reference()
    want = ref["slam_s0_rows300"]

    g_sim, g_probe = build("cuda")
    c_sim, c_probe = build("cpu")
    g_params, c_params = g_sim.params, c_sim.params
    diffs = param_diffs(g_params, c_params)
    print(f"parameters, card's build against the CPU's: {len(diffs)} leaves "
          f"differ: " + ", ".join(f"{p} {d:.2e}" for p, d in
                                  sorted(diffs.items())), flush=True)
    sums = {where: chip_smoke.check_leaf_sums(
        params, ref["slam_s0_leaf_paths"], ref["slam_s0_leaf_sums"],
        ref["slam_s0_leaf_device"], f"the {where}'s build")
        for where, params in (("card", g_params), ("cpu", c_params))}
    print(f"checksums against JAX's: {sums}", flush=True)

    # the card's parameters on both devices, step by step
    c_sim.params = to_device(g_params, "cpu")
    steps, g_trace, gc_trace = stepwise((g_sim, g_probe), (c_sim, c_probe))
    first_rows = [f"{x:.1e}" for x in steps["probe_row_max_abs_first_steps"]]
    print(f"card's parameters, card against CPU stepping: probe rows' "
          f"largest |diff| {steps['probe_row_max_abs_largest']:.2e}, in the "
          f"first steps {first_rows}", flush=True)
    for p, r in steps["populations"].items():
        print(f"  {p} ({r['n_neurons']} neurons): first spike flip at step "
              f"{r['first_spike_flip_step']}, voltage |diff| before it "
              f"{r['voltage_max_diff_before_first_flip']:.2e}; flips in the "
              f"first steps {r['flips_first_steps']}, in step {STEPS - 1} "
              f"{r['flips_last_step']}", flush=True)

    # the CPU's parameters on both devices, 300 steps at a time
    for sim in (g_sim, c_sim):
        sim.reset()
    c_sim.params = c_params
    g_sim.params = to_device(c_params, "cuda")
    g_sim.run_steps(STEPS)
    c_sim.run_steps(STEPS)
    # the float64 solve on the CPU
    x_sim, x_probe = build("cpu", torch.float64)
    exact = {where: param_diffs(params, x_sim.params)
             for where, params in (("card", g_params), ("cpu", c_params))}
    for where, d in exact.items():
        print(f"the {where}'s float32 solves against float64's: "
              + ", ".join(f"{p} {x:.2e}" for p, x in sorted(d.items())),
              flush=True)
    x_sim.run_steps(STEPS)
    traces = {"card_params_on_card": g_trace,
              "card_params_on_cpu": gc_trace,
              "cpu_params_on_cpu": c_sim.data[c_probe],
              "cpu_params_on_card": g_sim.data[g_probe],
              "float64_solve_on_cpu": x_sim.data[x_probe]}
    vs_jax = {k: chip_smoke.spike_flip_stats(t, want)
              for k, t in traces.items()}
    for k, st in vs_jax.items():
        print(f"{k} against JAX: median {st['median']:.3e}, q80 "
              f"{st['q80']:.3e}, peak {st['peak']:.3e}, first differing "
              f"step {st['first_differing_step']}", flush=True)
    same = chip_smoke.spike_flip_stats(traces["cpu_params_on_card"],
                                       traces["cpu_params_on_cpu"])
    print(f"CPU's parameters, card against CPU stepping: median "
          f"{same['median']:.3e}, q80 {same['q80']:.3e}, peak "
          f"{same['peak']:.3e}", flush=True)
    print(json.dumps({"card": card, "param_rel_diffs": diffs,
                      "leaf_checksums_vs_jax": sums,
                      "float32_vs_float64_solve": exact,
                      "vs_jax": vs_jax, "cpu_params_card_vs_cpu": same,
                      "card_params_card_vs_cpu": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
