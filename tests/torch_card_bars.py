"""The JAX package's slow science bars, run by the port on the card.

    python3 tests/torch_card_bars.py

Runs, as children on one CUDA card at once, the port's CLIs with the flags
of the JAX package's ``slow`` tests plus ``--device cuda``:

- ``validate_loop_closure`` at ``tests/test_headline.py``'s reduced
  protocol (ssp_dim 61, 400 per VCO, memory 600, 50 per convolution
  dimension, 30 landmarks, T = 100 s, ``--tuned``) for seeds 0, 1 and 2:
  SLAM median < 0.08, last quarter < 0.12, PI-only > 3x SLAM on both;
- ``kidnapped_robot`` at ``tests/test_kidnap_regression.py``'s two anchored
  tests (``test_anchor_channel_detection_and_recovery``,
  ``test_view_family_anchor_detection``), with their bars.

Prints each run's JSON and its bars, then one JSON line with the card's
name and power limit (``nvidia-smi``), every run's numbers and seconds and
whether its bars hold; exits 1 if a run fails, a bar does not hold or
the runs take more than TIMEOUT seconds together.  It
imports nothing of JAX: the card's machine has none.  Not part of
``chip_smoke.py``, whose time limit cannot take these runs.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 1500.0    # seconds the runs may take together

HEADLINE = ("--T", "100", "--ssp-dim", "61", "--pi-n-neurons", "400",
            "--mem-n-neurons", "600", "--circonv-n-neurons", "50",
            "--n-landmarks", "30", "--tuned")
KIDNAP = ("--in-model", "--T", "60", "--ssp-dim", "55", "--pi-n-neurons",
          "250", "--mem-n-neurons", "500", "--circonv-n-neurons", "50")
RUNS = {
    **{f"headline_seed{s}": ("validate_loop_closure",
                             (*HEADLINE, "--seed", str(s)))
       for s in (0, 1, 2)},
    "kidnap_anchor": ("kidnapped_robot",
                      ("--anchor", "--anchor-k", "6", "--auto-derive",
                       *KIDNAP, "--n-landmarks", "30", "--view-rad", "0.3",
                       "--seed", "0")),
    "kidnap_view_anchor": ("kidnapped_robot",
                           ("--model", "view", "--anchor", "--anchor-k", "4",
                            "--auto-derive", *KIDNAP, "--n-landmarks", "12",
                            "--view-rad", "0.35", "--update-thres", "0.2",
                            "--seed", "0")),
}


def headline_bars(r):
    return {"slam_median < 0.08": r["slam_median"] < 0.08,
            "slam_lastq < 0.12": r["slam_lastq"] < 0.12,
            "pi_median > 3 slam_median": r["pi_median"] > 3 * r["slam_median"],
            "pi_lastq > 3 slam_lastq": r["pi_lastq"] > 3 * r["slam_lastq"]}


def kidnap_anchor_bars(r):
    auto = r["auto"]
    return {"jump > 0.5": r["jump"] > 0.5,
            "in_view_frac_pre > 0.3": r["anchor"]["in_view_frac_pre"] > 0.3,
            "false_triggers == 0": auto["false_triggers"] == 0,
            "detect_s <= 5": auto["detect_s"] is not None
            and auto["detect_s"] <= 5.0,
            "adaptive post_err <= 0.3": r["adaptive"]["post_err"] <= 0.3,
            "adaptive < strict": r["adaptive"]["post_err"]
            < r["strict"]["post_err"],
            "strict post_err > 0.5": r["strict"]["post_err"] > 0.5}


def kidnap_view_bars(r):
    auto = r["auto"]
    return {"model == view": r["model"] == "view",
            "jump > 0.5": r["jump"] > 0.5,
            "in_view_frac_pre > 0.3": r["anchor"]["in_view_frac_pre"] > 0.3,
            "false_triggers == 0": auto["false_triggers"] == 0,
            "detect_s <= 10": auto["detect_s"] is not None
            and auto["detect_s"] <= 10.0,
            "adaptive pre_err <= 0.2": r["adaptive"]["pre_err"] <= 0.2,
            "adaptive < pi_only": r["adaptive"]["post_err"]
            < r["pi_only"]["post_err"]}


def bars_of(key):
    if key.startswith("headline"):
        return headline_bars
    return kidnap_anchor_bars if key == "kidnap_anchor" else kidnap_view_bars


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_card_bars: no CUDA device", file=sys.stderr)
        return 1
    card = nvidia_smi()
    print(card, flush=True)
    procs = {}
    for key, (module, flags) in RUNS.items():
        procs[key] = (subprocess.Popen(
            [sys.executable, "-m", f"sspslam_tpu_torch.experiments.{module}",
             *flags, "--device", "cuda"], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
                str(ROOT), os.environ.get("PYTHONPATH")])))),
            time.perf_counter())
    deadline = time.perf_counter() + TIMEOUT
    results, ok = {}, True
    try:
        for key, (proc, t0) in procs.items():
            out, err = proc.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            seconds = time.perf_counter() - t0
            lines = [l for l in out.splitlines() if l.startswith("{")]
            if proc.returncode != 0 or not lines:
                print(f"{key}: exit {proc.returncode}\n{err[-3000:]}",
                      flush=True)
                results[key] = {"exit": proc.returncode, "seconds": seconds}
                ok = False
                continue
            r = json.loads(lines[-1])
            bars = bars_of(key)(r)
            ok = ok and all(bars.values())
            results[key] = {"flags": list(RUNS[key][1]), "result": r,
                            "bars": bars, "bars_hold": all(bars.values()),
                            "seconds": seconds}
            print(f"{key} ({seconds:.1f} s): {json.dumps(r)}", flush=True)
            print(f"{key} bars: {bars}", flush=True)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(json.dumps({"card": card, "runs": results, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
