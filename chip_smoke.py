"""Smoke test of the PyTorch / CUDA port on one Hopper GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and imports nothing of JAX or of the JAX package.
Phases (each raises on failure, so the script exits non-zero and prints no
result line):

1. device: the card's name and power limit; TF32 off for matmuls and
   convolutions, so float32 comparisons are float32;
2. build: compiles ``sspslam_tpu_torch/csrc/vco_scan.cu`` for sm_90a;
3. kernel check, for every cluster size C the kernel is built for (CTAs
   per oscillator): at the path integrator's full width (ssp_dim 97 ->
   k = 49 oscillators, 800 LIF neurons each) the VCO-bank kernel against
   its plain PyTorch version on the same params and inputs: 40 steps to
   max-abs <= 2e-4, then a 2,000-step chunk and the main path's first
   10,000-step chunk to median |diff| <= 2e-3 (single spike flips grow
   with the step count, so the long chunks bound the median), and a
   second launch of that chunk from the same state to the first, bitwise
   (rows and state: the kernel sums in a fixed order); then 40
   steps at 48, 300 and 2,000 neurons per oscillator, which run the
   kernel's other neurons-per-thread variants.  The plain version's run
   of the main path's first chunk also counts its spikes, which set the
   kernel's bound (``bound_ms``);
4. cluster sweep: the kernel's time per 10,000-step chunk for each C in
   turns (1, 4, 4, 1) at full width, at 32 neurons per oscillator (the
   per-step floor: exchange and barrier latency with almost no neuron
   work), at the 3-D configurations of ``experiments/scaled_slam.py``
   (ssp_dim 201 and 801 -> k = 101 and 401, 800 LIF each) and at the
   first k oscillators of those builds for k on either side of the edges
   that ``_cluster_size`` and the waves of resident clusters set, each
   first held to the plain version over 40 steps; the card's clocks and
   power are sampled over the sweep, and the per-step times at n = 800
   and n = 32 are printed side by side for each C;
5. main path: ``FastPathIntegrator`` driven with ``bench.py --model
   pi-fast``'s traffic (one 10,000-step warm-up chunk, then 50,000 timed
   steps) at the C the wrapper picks, with the card's clocks and power
   read just before and just after the timed window; the kernel's launch
   count over that run must be > 0, and the warm-up chunk's trace must
   equal the direct launch of phase 3 and agree with the plain version's
   trace of the same chunk (median |diff| <= 2e-3);
6. whole run: the same 60,000 steps through the kernel at the other C; at
   every chunk end the two decoded positions must lie within 0.1 of each
   other (a third of the length scale 0.3);
7. accuracy: the constant-velocity integration test at full width (decode
   error < 0.25 after 800 steps);
8. the generic engine: ``nef.Simulator`` at full width on ``bench.py
   --model pi``'s traffic (the same velocities as phase 5, PathIntegration
   built from the same seed, LIF): its CUDA-graph replay against its eager
   step over the first 2,000 steps (max-abs <= 1e-6), CUDA kernels per
   step from one ``torch.profiler`` pass over 20 eager steps (and the
   device's busy share over 20 replayed steps), steps/s for graphs of
   U = 1, 10 and 100 steps (50,000 timed steps each) and for eager
   stepping (2,000), each after one 10,000-step warm-up segment, every
   U's trace equal to the first's, and the decoded positions of the
   Simulator's trace and the fast
   path's trace of phase 5 within 0.1 of each other at every 10,000-step
   boundary.  This path launches no hand-written kernel (the JAX engine
   reaches no Pallas kernel); the VCO kernel's count over it must stay 0.
   Then the Simulator's bookkeeping through graphs against the CPU's eager
   stepping on a small PES network (segment remainders, sparse snapshots,
   thinning, streamed and preloaded inputs, a learning rate changed in
   place, a checkpoint of the card's run continued on the CPU), within
   1e-4;
9. the constant-velocity accuracy gate through the Simulator at full width
   (decode error < 0.25 after 800 steps);
10. ``python -m sspslam_tpu_torch.experiments.run_pathint`` at its defaults
   (T = 20 s, ssp_dim 97, 800 LIF per VCO) as a subprocess: it must exit 0
   and print finite errors (printed, not gated: path integration alone
   drifts);
11. SLAM: ``SLAMNetwork`` at full width (82,280 LIF neurons: ssp_dim 97,
   800 per VCO, memory 970, 100 per circular-convolution dimension, clean-up
   over 100 x 100 samples in bf16) on ``bench.py --model slam``'s traffic
   (the 14 s world, 10 landmarks, view radius 0.8, the single-nearest
   adapter) through the Simulator: build time and resource summary; graph
   replay against the eager step over 2,000 steps (max-abs <= 1e-6);
   kernels per step from one profiler pass; the tracking cosine over the
   last quarter of the world from one run of its 14,000 steps (>= 0.93,
   bench.py's gate); the gate's hoisted ``shift_rate`` set to 0 in place
   changes the next replay with no new capture, and the replay equals the
   eager step at 0; steps/s over 2,000 timed steps after one 2,000-step
   warm-up segment (inputs past the world repeat its last row), the card's
   clocks and power read just before and after;
12. ``SLAMNetwork(gate_mode="auto_recovery", anchor=True)`` at the same
   width with 3 surveyed landmarks: graph replay against eager over 2,000
   steps (max-abs <= 1e-6) — the stateful gate and its in-step bind /
   unbind inside a captured graph.  Neither SLAM path launches the VCO
   kernel (count 0), as the JAX package's SLAMNetwork reaches no Pallas
   kernel;
13. ``python -m sspslam_tpu_torch.experiments.run_slam --T 20`` at its
   default widths as a subprocess: exit 0 and finite errors (printed, not
   gated);
14. ``SLAMGatedNetwork`` (the all-neural gate, ≈ 92,000 LIF: 800 per VCO,
   memory 970, 100 per circular-convolution dimension and for the dot
   product) on phase 11's traffic: build time and neuron count, graph
   replay against eager over 2,000 steps (max-abs <= 1e-6), kernels per
   step, the tracking cosine over the world (printed: the JAX package sets
   no gate for this model), steps/s over 2,000 timed steps after one
   warm-up segment with the clocks and power read around them;
15. ``SLAMViewNetwork`` at ``run_slamview``'s default widths (700 per VCO,
   memory 970, grid clean-up over 100 x 100) fed by
   ``get_slamview_input_functions`` on the same world: the checks of phase
   14; then the auto-recovery gate with 3 surveyed landmarks, replay
   against eager (<= 1e-6);
16. the clean-up methods: ``train_decoder_net`` at its defaults on the
   card (time, final loss); ``decode`` of 1,000 random points by from-set,
   direct-optim, network and network-optim (median errors; direct-optim
   must be no worse than from-set); ``SLAMNetwork`` at phase 11's width
   with each of the direct-optim, network and network-optim clean-ups,
   replay against eager over 2,000 steps (<= 1e-6), and for direct-optim
   kernels per step and steps/s over 2,000 timed steps;
17. ``PathIntegrationReencode``, ``PathIntegrationGC`` and
   ``PathIntegrationBCsGCs`` at ssp_dim 97, 800 neurons per ensemble, on
   phase 8's velocities: replay against eager over 1,000 steps (<= 1e-6)
   and the decoded error at the end (printed);
18. ``run_slamview --T 20`` and ``run_slam --backend gated --T 20`` as
   subprocesses: exit 0 and finite errors (printed, not gated).  The VCO
   kernel launches 0 times over phases 14-18, as the JAX package reaches
   no Pallas kernel on these paths;
19. quantised storage: phase 11's SLAMNetwork and traffic with
   ``matmul_dtype="int8"`` and again ``"fp8"``: graph replay against eager
   over 2,000 steps (<= 1e-6), kernels per replayed step, the tracking
   cosine over the world (int8 at most 0.05 below float32's, see
   ``QUANT_TRACKING_BAND``), steps/s over 2,000 timed steps and the bytes
   of the parameter tree, each beside phase 11's float32 numbers;
20. batched episodes: phase 11's float32 model, B = 1, 8 and 32 episodes
   of the bench world (episode b's landmarks from seed b) through
   ``parallel.BatchedEpisodes``: aggregate steps/s over 2,000 timed steps
   after a warm-up segment, kernels per replayed batched step (at most
   1.2 x B = 1's: the batch did not loop), peak device memory; at B = 8 the
   batched replay against its eager step over 1,000 steps (<= 1e-6), both
   with every ``LIF.step`` call through the ATen chain (the step under
   ``torch.func.vmap``), and each episode against a plain Simulator run of
   it over 2,000 steps (see ``batched_episodes``);
21. the reference's second bar: ``python -m
   sspslam_tpu_torch.experiments.scaled_slam --T 40 --seeds 0,1
   --param-dtype int8 --no-pi-control`` (ssp_dim 201 in 3-D, 101 VCOs x 800
   LIF, memory 10,000, 100 landmarks, 2 batched episodes) as a subprocess:
   exit 0 and median_err_slam <= 0.4 (``--save``: the npz phase 30
   re-decodes); then its ``--dp-sweep 1,2,8`` at T = 4 (``--limit 0.3``),
   one row per B.  The VCO kernel launches 0 times over phases 19-21;
22. training at the PI fast path's full width (``train_pathint``'s model
   and worlds: ssp_dim 97, 49 VCOs x 800 LIFRate, 600 steps, segments of
   100): the gradient of its loss with respect to the recurrent decoders
   through checkpointed segments against the plain loop (within 1e-5
   relative), the peak device memory of each (remat's lower), kernels per
   step under autograd beside the replayed step's; the card's gradient
   with respect to the readout decoders against the CPU's on the same
   params, TF32 off (within 1e-4 relative; the recurrent decoders'
   difference is printed beside its change under a one-rounding nudge:
   LIFRate's slope is unbounded at threshold); the recurrent decoders'
   gradient of one 100-step segment of the same model with
   RectifiedLinear neurons, card against CPU (within 1e-4 relative), the
   nudge moving it by at most 1e-5; ``SurrogateLIF``'s forward pass
   against ``LIF``'s over 300 steps (rtol 1e-5); ``train_pathint`` with
   5 fit steps as a subprocess (its loss falls; seconds per fit step);
23. ``train_slam`` at the flagship width (ssp_dim 97, 800 per VCO, memory
   970, 100 per circular-convolution dimension; T = 0.6 s, 2 meta-steps)
   as a subprocess, run with the untimed children: its losses, first
   meta-gradient and tuned scalars finite, the scalars non-negative,
   seconds per meta-step (printed; taken beside the other children), peak
   memory (the gate has not corrected by then, so the meta-gradient is
   0);
   ``train_slam`` at a tiny width and T = 0.5 s on the card and on the
   CPU: the first meta-gradients nonzero and within 5e-3 of each other;
   ``tune_loop_closure``'s in-place configuration of a built simulator
   against a fresh build with that configuration on its 1 s world at the
   default (flagship) widths (max-abs <= 1e-6 over the trace and final
   state, the same graphs replayed, the state moved from the base run);
   ``tune_loop_closure --quick --T 1 --final-T 1 --top 1`` at its default
   widths: 8 finite rows;
24. a ``ClosedLoopSession`` on phase 11's SLAM, ticks of 50 steps fed the
   bench world's rows, against one uninterrupted ``run_steps`` of them
   over 2,000 steps (max-abs <= 1e-6), one capture for the tick length
   over all ticks, the tick latency (median, p90, p99 over 100 ticks);
   ``closed_loop_nav`` at its defaults as a subprocess (its JSON line).
   The VCO kernel launches 0 times over phases 22-24;
25. the serving bundle: phase 11's SLAM warmed for 2,000 steps and
   ``save_bundle``d (export seconds, MB), served by ``ServingModel`` on the
   card (CUDA graphs of the exported step) against the live Simulator's
   continued run of the same 2,000 rows (max-abs <= 1e-6); the same
   bundle served by a child process that builds nothing (the builder
   patched to raise) and imports no JAX (its rows equal this process's);
   a bundle exported on the CPU from the same model served on the card
   (<= 1e-6 against the live run); an int8 bundle against its live run
   (<= 1e-6); served (per-segment upload and the final pull included) and
   live steps/s over 2,000 timed steps; kernels per replayed served step;
   ``serving_probe``'s JSON keys present and finite; the ``LIF.step``
   calls of the live warm-up all through the LIF kernel, and those of the
   export's trace all through the ATen chain (``lif.fused`` /
   ``lif.plain``; the one real step before the trace takes the kernel);
26. the NumPy interpreter (``NumpyStepper``) on phase 11's model built
   with SSPSLAM_CLEANUP_F32=1 against the card's Simulator over 300 steps,
   within the spike-flip bounds; its steps/s on this host and the card's
   ratio to it; ``run_slam --backend numpy --T 0.3``: exit 0, finite
   errors;
27. the native host library built by g++ at first use and loaded, its six
   functions equal to their NumPy fallbacks (tests/test_native.py's
   tolerances); ``trace_run`` around 100 replayed SLAM steps writes a
   Chrome trace naming the step's kernels.  The VCO kernel launches 0
   times over phases 25-27;
28. loop closure and the kidnap: ``validate_loop_closure --tuned`` at the
   flagship protocol (ssp_dim 97, 800 per VCO, memory 970, 100 per
   convolution dimension, 50 landmarks, view radius 0.2, T = 200 s) held
   to tests/test_headline.py's bars (SLAM median < 0.08, last-quarter <
   0.12, PI > 3x SLAM on both); ``kidnapped_robot --in-model`` at
   tests/test_kidnap_regression.py's flags held to its bars (jump > 0.5,
   no false trigger, detection within 27 s, adaptive post-kidnap error
   below the strict gate's, strict > 0.5); the flagship scripted
   ``kidnapped_robot --T 20 --recovery-window 4 --dump`` and
   ``check_anchor_enters`` on its npz (finite); in this process, the
   flagship three-model program with the recovery window written in
   place at step 300 and restored at 600: graph replay against the eager
   step over 1,000 steps (<= 1e-6), no recapture, the same params
   tensors, and a run without the window differing after step 300;
29. maps: ``map_merge --T-explore 10 --T-test 6 --test-limit 0.4
   --eval-gate auto_recovery`` and ``live_merge --T 10 --exchange-s 2
   --limit 0.5`` at the flagship widths, every condition and arm finite
   (at the default limit these short paths stand still); in this process
   the merge of two flagship maps on the card against the formula on the
   host (0) and injected in place, and one live exchange of two flagship
   batched episodes against A + B - M_prev (0) followed by 1,000 replayed
   batched steps against eager ones (<= 1e-6);
30. analyses: ``gate_fidelity --T 2`` at the flagship widths (engaged
   fractions), ``bf16_drift --T 10`` (trajectory cosine, both steps/s),
   ``scale_study --dims 97,193 --steps 2000 --segment-steps 1000 --reps
   1`` (MFLOP/step at d = 97 equal to the model summary of the flagship
   model built here) and ``redecode_scaled`` on phase 21's ``--save`` npz
   (polished median <= grid median).  The VCO kernel launches 0 times
   over phases 28-30 and their children;
31. the sharded scan (run after phase 7, while the card is quiet):
   ``parallel.make_sharded_vco_scan`` at phase 3's width with the
   oscillators split into S = 1, 2, 4 and 7 shards, each shard's kernel on
   its own CUDA stream: against the plain sharded scan on the card over 40
   steps (max-abs <= 2e-4), one 10,000-step chunk of the main path's
   traffic against the unsharded kernel's trace of it (median |diff| <=
   2e-3, decoded positions at the chunk end within 0.1) with exactly S
   kernel launches, and ms per chunk (CUDA events);
32. the demos: ``run_pathint_gif``, ``run_slam_map_gif`` and
   ``slam_map_new`` at their default widths through their ``build`` and
   ``simulate`` (the scripts' simulation and readout; the card's machine
   has no matplotlib to render): graph replay against the eager step
   over 300 steps, every probe (the sparse snapshots of learned weights
   included) and state leaf (<= 1e-6); then runs of 10, 10 and 20 s
   (steps/s, taken beside the CLI children; every array finite;
   ``slam_map_new``'s tracking cosine, item errors and area-query sims,
   its tracking within 0.04 of the JAX script's at the same T and widths
   from ``tests/reference/full_width_jax.npz``, its item errors printed
   beside JAX's).  The VCO kernel launches 0 times;
33. the port's benchmark (run after phase 12, while the card is quiet),
   its ``main`` in this process as ``python -m sspslam_tpu_torch.bench``
   runs it: ``--model pi-fast`` at the defaults under one profiler pass
   (6 ``vco_scan`` launches by the wrapper's count, by the bench row and
   by the kernels named in the trace, and 0 calls of the plain version);
   ``--model slam --reps 1 --timed-steps 10000 --baseline-reps 1
   --no-scaled-spot`` (platform ``gpu``, ``accuracy_pass``, device us per
   step > 0, ``flops_per_step`` equal to phase 11's model summary, mfu >
   0, ``vs_baseline`` finite, 0 VCO launches); then
   ``experiments.step_roofline.roofline`` once on the same model, beside
   that run's device time (the same FLOPs, a bound below the measured
   time, 0 VCO launches);
34. the JAX package's full-width reference,
   ``tests/reference/full_width_jax.npz`` (made on the CPU by
   ``tests/make_jax_reference.py``; read here as data).  Fast path, on
   phase 5's 60,000-step run (after phase 6, no extra card time): the
   built parameters' checksums (sum, L2, L1 and a position-weighted sum
   of every leaf; 1e-6 relative for host solves and seeded draws, 1e-4
   for float32 device solves), the first 40 rows within 2e-4 of JAX's
   Pallas kernel in interpret mode, the decoded position at each of the
   six chunk ends within 0.1 of JAX's, the median |diff| of every 1,000th
   row printed.  SLAM, beside the CLI children (with phases 28-30 and
   32): for each of the reference's seeds (0-4), ``bench.build`` on the
   card and its 14,000-step world replayed from the fresh state: the
   checksums; the first 300 probe rows against JAX's by the spike-flip
   bounds (median, q80 and peak held, the other two printed); the
   tracking cosine within 0.04 of JAX's per seed and the five seeds'
   means within 0.02; the decoded position at every 1,000th step against
   JAX's (largest, median, the first step past 0.1; printed).  Both sides keep the bf16 clean-up.  0 VCO launches.
35. the multi-device path, as one child beside phase 34's (``python3
   tests/torch_card_sharded.py --smoke``): at world = min(4, cards)
   ranks, one card and one process each under NCCL, the multi-device dry
   run (``python -m sspslam_tpu_torch.parallel.dryrun``), then bench.py's
   seed-0 SLAM world at full width sharded over the ranks for 300 steps,
   its collectives inside the captured graphs, against the unsharded
   Simulator on card 0 (the spike-flip bounds' median, q80 and peak), and
   the VCO kernel's oscillator shards on the ranks
   (``make_sharded_vco_scan(mesh=...)``: one ``vco_scan`` launch a rank a
   chunk, 2 chunks, the median |diff| to the unsharded kernel within
   2e-4).  The dry run ends with its bundle step (``save_bundle`` of the
   sharded tiny SLAM, one 4-step segment of zero rows served by
   ``ServingModel`` on every rank: finite, the same on every rank); the
   full-width run saves a sharded serving bundle from the fresh state
   before its 300 live steps (one program a model coordinate, its
   all-reduces as many as the live step's) and serves the same 300 rows
   from it on every rank in segments of 100, within 1e-6 of the live rows
   (phase 25's bound).  Prints the world size it ran, the all-reduces a
   step, the export's seconds and megabytes, and served and live steps/s
   (the median of the segments after the first).  0 VCO launches on the
   served path.
36. the program's spans (``utils.profiling``; run after phase 31, while
   the card is quiet) on the benchmark cell's episode at the main path's
   width (``FastPathIntegrator.run`` of 20,000 steps: the velocity and
   correction tables up, two launches, the trace down): 20 episodes under
   ``torch.profiler``, split by span (``pi.initial_state``, ``pi.run``,
   ``pi.upload``, ``vco_scan.call``, ``pi.wait``, ``pi.download``, the
   run's self time) beside the kernel's records, with two
   ``vco_scan.call`` a ``pi.run``, ``pi.run`` + ``pi.initial_state``
   within 3 % of the episode on the host clock, ``pi.wait`` 1.8-2.05 x
   the kernel's mean record and no device record named after a span;
   ``trace_run`` around 3 episodes, whose Chrome trace must show each
   kernel record starting after its ``vco_scan.call`` span starts and
   each episode's second kernel ending before its ``pi.wait`` ends (the
   margins and the span clock's offset printed); then the cost of
   tracing: 8 pairs of 20 episodes with ``profiling.tracing()`` off and
   on, in turns;
37. the LIF kernel (``csrc/lif_step.cu``, after phase 12): its nvcc
   build time; at the SLAM network's four LIF group shapes (OVC 970;
   memory, error and recall 3 x 970; the VCO bank 49 x 800; the
   convolutions' products 784 x 50) and at one rank's rows of each
   (rank 1 of 4, the sharded step's slice), ``LIF.step`` through the
   kernel against the ATen chain (``neurons._lif_step_plain``) bitwise
   over 50 steps, from inputs with J below and above 1, neurons
   mid-refractory, spikes and voltages below ``min_voltage``, and once
   more with other constants; each shape's time per call, kernel and
   chain, inside a CUDA graph of 100 calls; then the flagship SLAM of
   phase 11 over 1,000 steps through its 10-step graphs, its probe rows
   and every state leaf bitwise those of the same run with ``LIF.step``
   patched to the chain, and ``lif.fused`` = 4 a captured step, 0
   ``lif.plain``.  ``--lif`` runs it alone.

Every CLI subprocess (phases 10, 13, 18, 21-26 and 28-30) runs its module
as ``python -m`` does, through runpy, and then prints the VCO kernel's
launches in that process, which must be 0.  The children whose times the
smoke does not report as readings (phases 10, 13 and 18, 23's sweep and
three ``train_slam`` runs, 25's ``serving_probe``, 26's ``run_slam
--backend numpy`` and the CLIs of phases 28-30 but ``check_anchor_enters`` and
``redecode_scaled``, which read files phases 21 and 28 write) run together
after phase 17, while the smoke's own process runs the in-process checks
of phases 28-30, none of which is timed, phase 32 and phase 34's SLAM
worlds.

The last sixteen lines of standard output are one JSON object of the
Simulator's numbers, one of the SLAM numbers, one of phase 37 (``lif``),
one of phases 14-18
(``family``), one of phases 19-21 (``scaled``), one of phases 22-24
(``train``), one of phases 25-27 (``serving``), one of phases 28-30
(``clis``), one of phases 31-32 (``sharded``, ``demos``), one of phase 33
(``bench``), one of phase 34 (``reference``), one of phase 35
(``mesh``), one of phase 36 (``tracing``), the card's name and power
limit, one JSON object describing the kernel, and the result line.

To compare the kernel of two checkouts on one card, time each in turns
within one command (the other commit unpacked into a git-ignored
directory, e.g. ``git archive <commit> | tar -x -C build/parent``):

    for r in build/parent . . build/parent; do
        python3 chip_smoke.py --time "$r"; done

``--time ROOT`` imports ``sspslam_tpu_torch`` from ROOT, times its
``vco_scan`` at the cluster size it picks on the main path's first chunk
and prints one JSON line; it runs none of the phases above.
``--tracing`` runs phase 36 alone and prints its JSON line and the card's
name and power limit; ``--lif`` does so for phase 37.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SSP_DIM = 97
N_NEURONS = 800
FLOOR_NEURONS = 32
CHUNK = 10_000
TIMED = 50_000
SEED = 0
SHORT, LONG = 40, 2_000
SHORT_TOL = 2e-4      # max-abs over 40 steps (tests/test_pallas.py bound)
LONG_MEDIAN_TOL = 2e-3  # median |diff| over one 2,000- or 10,000-step chunk
DRIFT_TOL = 0.1       # decoded-position difference, two kernels, whole run
ACCURACY_TOL = 0.25   # decode error after 800 steps at constant velocity
GRAPH_UNITS = (1, 10, 100)  # steps per captured CUDA graph, timed in turn
EAGER_TIMED = 2_000   # eager steps timed on PI (after one warm-up segment)
EAGER_WARM = 1_000    # the eager timing's warm-up segment (no capture)
# timed steps of the SLAM-family Simulator paths (phases 11, 14-16, 19),
# after one SIM_WARM-step warm-up segment (the graphs' capture included):
# kept short so the smoke fits its time limit on a slow host (PERF.md)
SIM_TIMED = 2_000
SIM_WARM = 2_000
REPLAY_TOL = 1e-6     # graph replay vs eager step, max-abs over LONG steps
PROFILE_STEPS = 20    # the counts per step read the same as over 100 steps
# bench.py --model slam: the 14 s world, 10 landmarks, view radius 0.8; the
# anchor phase surveys the first 3 landmarks; the tracking gate is bench.py's
WORLD_STEPS = 14_000
SLAM_LANDMARKS = 10
VIEW_RAD = 0.8
ANCHORS = 3
TRACKING_GATE = 0.93
SHIFT_STEPS = 1_000   # steps replayed per setting of a hoisted threshold
SWEEP = (1, 4, 4, 1)
SWEEP_REPEATS = 3
TIME_REPEATS = 5
# The sweep's widths: (name, domain dim, ssp_dim, neurons per oscillator,
# oscillators).  None takes the build's own k; a number takes the first k
# oscillators of the build: on either side of k = 92, where the wrapper's
# choice of C changes on 132 SMs, and of where a wave of resident clusters
# ends; and one point at which that choice is not the faster (PERF.md).
SWEEP_WIDTHS = (
    ("full width", 2, SSP_DIM, N_NEURONS, None),
    ("floor", 2, SSP_DIM, FLOOR_NEURONS, None),
    ("3-D ssp_dim 201, first 62", 3, 201, N_NEURONS, 62),
    ("3-D ssp_dim 201, first 63", 3, 201, N_NEURONS, 63),
    ("3-D ssp_dim 201, first 92", 3, 201, N_NEURONS, 92),
    ("3-D ssp_dim 201, first 93", 3, 201, N_NEURONS, 93),
    ("3-D ssp_dim 201, n = 400, first 66", 3, 201, 400, 66),
    ("3-D ssp_dim 201", 3, 201, N_NEURONS, None),
    ("3-D ssp_dim 801", 3, 801, N_NEURONS, None),
    *((f"3-D ssp_dim 801, first {k}", 3, 801, N_NEURONS, k)
      for k in (124, 125, 132, 133, 264, 265)),
)

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): float32
# outside the tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# The float32 operations the VCO bank needs (an FMA is two; a division,
# expm1f or log1pf one; compares, selects and min/max are not counted).
# Every neuron and step: the currents 6, the voltage 3, the refractory
# clock 1.
FLOP_NEURON = 10
# Each spike: the spike time (J - 1, volt - 1, the division, log1pf and
# its FMA, + tau_ref) 7; the one step after it whose decay factor is not a
# constant (dt - refr, the division, expm1f) 3; its five decoder values
# added to the decodes 5 (a silent neuron adds nothing).
FLOP_SPIKE = 15
# Every oscillator and step: the three inputs 4, five filters 15.
FLOP_OSC = 19


_START = time.perf_counter()


def log(msg):
    """One line of the run's record, after the seconds since the start."""
    print(f"[{time.perf_counter() - _START:6.0f} s] {msg}", flush=True)


def reset_vco_launches():
    """Zero the port's counters (``utils.profiling``), the VCO kernel's
    launches among them."""
    from sspslam_tpu_torch.utils import profiling
    profiling.reset()


def vco_launches() -> int:
    """The VCO kernel's launches in this process since the last
    :func:`reset_vco_launches`."""
    from sspslam_tpu_torch.utils import profiling
    return profiling.counter("vco_scan.launches")


def lif_calls(fn):
    """(``lif.fused``, ``lif.plain``): the ``LIF.step`` calls that took the
    kernel and the ATen chain while ``fn()`` ran under
    ``profiling.tracing()`` (the counters count only while tracing; the
    other counters are left as they were)."""
    from sspslam_tpu_torch.utils import profiling
    names = ("lif.fused", "lif.plain")
    before = [profiling.counter(k) for k in names]
    with profiling.tracing():
        fn()
    return tuple(profiling.counter(k) - b for k, b in zip(names, before))


def nvidia_smi(query="name,power.limit") -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


class ClockSampler:
    """nvidia-smi's SM clock, power draw and limit, and temperature every
    200 ms while the block runs; the child process is stopped on exit."""

    QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.QUERY}",
             "--format=csv,noheader", "-lms", "200"],
            stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.lines = [line for line in out.splitlines() if line.strip()]
        return False

    def summary(self) -> str:
        if not self.lines:
            return "no samples"
        cols = [[c.strip() for c in line.split(",")] for line in self.lines]
        clocks = [c[0] for c in cols]
        draws = [c[1] for c in cols]
        return (f"{len(cols)} samples ({self.QUERY}): SM clock "
                f"{min(clocks)}..{max(clocks)}, power draw "
                f"{min(draws)}..{max(draws)}, limit {cols[0][2]}, "
                f"temperature {cols[-1][3]} C")


def make_space(space_cls, ssp_dim=SSP_DIM, dim=2):
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (dim, 1))
    return space_cls(dim, ssp_dim=ssp_dim, seed=SEED, length_scale=0.3,
                     domain_bounds=bounds)


def cuda_ms(fn, repeats=1):
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        result = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats, result


def traffic(dim=2):
    """bench.py --model pi-fast's velocities: warm-up chunk, then timed."""
    rng = np.random.default_rng(SEED)
    return (0.02 * rng.normal(size=(CHUNK + TIMED, dim))).astype(np.float32)


def bound_ms(n, k, d, N, T, spikes):
    """The least time of one ``vco_scan`` call (kernel and output
    projection) on the card, for a chunk whose neurons spike ``spikes``
    times: its float32 operations over PEAK_F32 and its bytes (each input
    read once, each output written once) over PEAK_BYTES, whichever is
    larger; returns (ms, "operations"|"bytes")."""
    flop = (T * k * (n * FLOP_NEURON + FLOP_OSC) + spikes * FLOP_SPIKE
            + 2 * T * k * (2 * d + N)      # the input projections
            + 2 * T * 2 * k * d)           # rows @ [ts0T; ts1T]
    floats_in = (9 * n * k + k             # neuron params, dc_mask
                 + (2 * d + N) * k         # tf0T, tf1T, velT_T
                 + 2 * k * d               # ts0T, ts1T
                 + T * (N + d)             # vel, corr
                 + 2 * n * k + 5 * k)      # state
    floats_out = T * d + 2 * n * k + 5 * k  # SSP trace, state
    t_ops = flop / PEAK_F32 * 1e3
    t_bytes = 4 * (floats_in + floats_out) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode(space, rows):
    return space.decode(np.atleast_2d(np.asarray(rows)), num_samples=100,
                        device="cuda")


def check_long(space, y_k, y_p, what):
    """Median |diff| of two long SSP traces within LONG_MEDIAN_TOL; prints
    the max-abs and the difference of the last decoded positions."""
    y_k, y_p = torch.as_tensor(y_k).cpu(), torch.as_tensor(y_p).cpu()
    if y_k.shape != y_p.shape:
        raise AssertionError(f"{what}: shapes {tuple(y_k.shape)} and "
                             f"{tuple(y_p.shape)} differ")
    diff = (y_k - y_p).abs()
    med = float(diff.median())
    pos_k = decode(space, y_k[-1:].numpy())
    pos_p = decode(space, y_p[-1:].numpy())
    log(f"{what}: max-abs {float(diff.max()):.3e}, median {med:.3e} "
        f"(tol {LONG_MEDIAN_TOL}), decoded position difference "
        f"{float(np.linalg.norm(pos_k - pos_p)):.4f}")
    if not med <= LONG_MEDIAN_TOL:
        raise AssertionError(f"{what}: median |diff| {med} > "
                             f"{LONG_MEDIAN_TOL}")


def count_spikes(vco, params, state, vel, corr, trace):
    """The spikes of the plain version's run of one chunk: its loop again,
    its LIF chain (``_lif_step_plain``) wrapped to count the spikes it
    emits; its SSP trace must equal ``trace``, the plain version's own."""
    from unittest import mock
    xc0, xc1 = corr @ params.tf0T, corr @ params.tf1T
    xv = vel @ params.velT_T
    spikes = torch.zeros((), dtype=torch.int64, device=vel.device)
    plain = vco._lif_step_plain

    def counted(lif, st, J, dt):
        new, act = plain(lif, st, J, dt)
        spikes.add_(torch.count_nonzero(act))
        return new, act
    rows = []
    with mock.patch.object(vco, "_lif_step_plain", counted):
        for t in range(vel.shape[0]):
            state = vco._vco_step(params, vco._lif(params), state,
                                  xc0[t:t + 1], xc1[t:t + 1], xv[t:t + 1])
            rows.append(state.fout)
    if not torch.equal(torch.cat(rows) @ vco.output_projection(params),
                       trace):
        raise AssertionError("the counted run differs from the plain version")
    return int(spikes)


def check_kernel(fpi, space, vco):
    """Kernel vs plain version on the card, same params and inputs, for
    every cluster size; returns the worst 40-step max-abs, the plain
    version's time over the main path's first chunk and that chunk's
    spikes, and that chunk's trace from the kernel (per C) and from the
    plain version."""
    params, d = fpi.params, fpi.d
    rng = np.random.default_rng(1)
    T = SHORT + LONG
    vel = torch.tensor(0.02 * rng.normal(size=(T, 2)), dtype=torch.float32,
                       device=fpi.device)
    corr = torch.zeros((T, d), dtype=torch.float32, device=fpi.device)
    corr[:20] = torch.tensor(space.encode(np.array([[0.1, -0.2]])).ravel(),
                             dtype=torch.float32)
    state0 = fpi.initial_state()
    s_p, y_p = vco.vco_scan_reference(params, state0, vel[:SHORT],
                                      corr[:SHORT])
    _, y_p_long = vco.vco_scan_reference(params, s_p, vel[SHORT:],
                                         corr[SHORT:])
    # the main path's first chunk (CHUNK steps of its own traffic, from the
    # zero state)
    vel_c = torch.tensor(traffic()[:CHUNK], device=fpi.device)
    corr_c = torch.zeros((CHUNK, d), dtype=torch.float32, device=fpi.device)
    plain_ms, (_, y_p_chunk) = cuda_ms(
        lambda: vco.vco_scan_reference(params, state0, vel_c, corr_c))
    log(f"plain version, one {CHUNK}-step chunk: {plain_ms:.1f} ms "
        f"({CHUNK / plain_ms * 1e3:.0f} steps/s)")
    spikes = count_spikes(vco, params, state0, vel_c, corr_c, y_p_chunk)
    log(f"plain version, one {CHUNK}-step chunk: {spikes} spikes = "
        f"{spikes / (CHUNK * fpi.k * fpi.n):.5f} per neuron and step")

    worst, y_chunk = 0.0, {}
    for C in vco.CLUSTER_SIZES:
        s_k, y_k = vco._vco_scan_cuda(params, state0, vel[:SHORT],
                                      corr[:SHORT], cluster=C)
        err = float((y_k - y_p).abs().max())
        log(f"C={C}: kernel vs plain, {SHORT} steps: max-abs {err:.3e} "
            f"(tol {SHORT_TOL})")
        if not err <= SHORT_TOL:
            raise AssertionError(f"kernel (C={C}) disagrees with its plain "
                                 f"version: {err} > {SHORT_TOL}")
        worst = max(worst, err)
        # one long chunk, each version continuing from its own state
        _, y_k = vco._vco_scan_cuda(params, s_k, vel[SHORT:], corr[SHORT:],
                                    cluster=C)
        check_long(space, y_k, y_p_long,
                   f"C={C}: kernel vs plain, {LONG} steps")
        s_a, y_chunk[C] = vco._vco_scan_cuda(params, state0, vel_c, corr_c,
                                             cluster=C)
        check_long(space, y_chunk[C], y_p_chunk,
                   f"C={C}: kernel vs plain, {CHUNK} steps")
        # the design's promise: no atomics, every sum in a fixed order
        s_b, y_b = vco._vco_scan_cuda(params, state0, vel_c, corr_c,
                                      cluster=C)
        if not (torch.equal(y_b, y_chunk[C])
                and all(torch.equal(a, b) for a, b in zip(s_a, s_b))):
            raise AssertionError(f"C={C}: two launches from the same state "
                                 f"differ")
        log(f"C={C}: two launches of the {CHUNK}-step chunk from the same "
            f"state: rows and state bitwise identical")
    return worst, plain_ms, spikes, y_chunk, y_p_chunk


def check_other_widths(vco, space_cls, fpi_cls):
    """The kernel's other neurons-per-thread variants (n = 48, 300 and
    2,000 at ssp_dim 31) against the plain version, 40 steps, every C."""
    space = make_space(space_cls, ssp_dim=31)
    rng = np.random.default_rng(2)
    vel = torch.tensor(0.05 * rng.normal(size=(SHORT, 2)),
                       dtype=torch.float32, device="cuda")
    corr = torch.zeros((SHORT, space.ssp_dim), dtype=torch.float32,
                       device="cuda")
    corr[:10] = torch.tensor(space.encode(np.array([[0.3, 0.1]])).ravel(),
                             dtype=torch.float32)
    for n in (48, 300, 2000):
        fpi = fpi_cls(space, n, seed=SEED, device="cuda")
        state0 = fpi.initial_state()
        _, y_p = vco.vco_scan_reference(fpi.params, state0, vel, corr)
        for C in vco.CLUSTER_SIZES:
            _, y_k = vco._vco_scan_cuda(fpi.params, state0, vel, corr,
                                        cluster=C)
            err = float((y_k - y_p).abs().max())
            log(f"C={C}: kernel vs plain, n={n}, k={fpi.k}, {SHORT} steps: "
                f"max-abs {err:.3e} (tol {SHORT_TOL})")
            if not err <= SHORT_TOL:
                raise AssertionError(f"kernel disagrees at n={n}, C={C}: "
                                     f"{err}")


def first_oscillators(vco, params, k):
    """The bank of the first k oscillators of ``params``."""
    cut = {f: getattr(params, f)[:k].contiguous()
           if f in ("ts0T", "ts1T") else getattr(params, f)[:, :k].contiguous()
           for f in vco.ARRAY_FIELDS}
    return params._replace(**cut)


def sweep(vco, params, vel, corr):
    """The kernel at every C against the plain version over SHORT steps,
    then ms per CHUNK-step chunk for each C of SWEEP, in that order."""
    n, k = params.bias.shape
    state0 = vco.initial_vco_state(n, k, device="cuda")
    _, y_p = vco.vco_scan_reference(params, state0, vel[:SHORT],
                                    corr[:SHORT])
    for C in vco.CLUSTER_SIZES:
        _, y_k = vco._vco_scan_cuda(params, state0, vel[:SHORT],
                                    corr[:SHORT], cluster=C)
        err = float((y_k - y_p).abs().max())
        if not err <= SHORT_TOL:
            raise AssertionError(f"kernel disagrees at n={n}, k={k}, C={C}: "
                                 f"{err}")
    times = {}
    for C in SWEEP:
        def launch():
            return vco._vco_scan_cuda(params, state0, vel, corr, cluster=C)
        launch()  # warm-up
        ms, _ = cuda_ms(launch, SWEEP_REPEATS)
        times.setdefault(C, []).append(ms)
    return times


def cluster_sweep(vco, fpi, space_cls, fpi_cls, num_sms):
    """Phase 4: the C sweep at every width of SWEEP_WIDTHS, timed in that
    order, each on the main path's first chunk of traffic (no
    corrections).  Returns {name: {C: [ms, ...]}}."""
    builds = {(2, SSP_DIM, N_NEURONS): fpi}
    results = {}
    with ClockSampler() as clocks:
        for name, dim, ssp_dim, n, k in SWEEP_WIDTHS:
            if (dim, ssp_dim, n) not in builds:
                builds[dim, ssp_dim, n] = fpi_cls(
                    make_space(space_cls, ssp_dim, dim), n, seed=SEED,
                    device="cuda")
            build = builds[dim, ssp_dim, n]
            params = (build.params if k is None
                      else first_oscillators(vco, build.params, k))
            vel = torch.tensor(traffic(dim)[:CHUNK], device="cuda")
            corr = torch.zeros((CHUNK, build.d), dtype=torch.float32,
                               device="cuda")
            results[name] = times = sweep(vco, params, vel, corr)
            k = params.bias.shape[1]
            fastest = min(times, key=lambda C: np.mean(times[C]))
            for C, ms in times.items():
                log(f"sweep, {name} (n={n}, k={k}), C={C}: ms per "
                    f"{CHUNK}-step chunk "
                    f"{', '.join(f'{t:.3f}' for t in ms)} = "
                    f"{np.mean(ms) / CHUNK * 1e6:.1f} ns per step")
            log(f"sweep, {name}: kernel vs plain <= {SHORT_TOL} over "
                f"{SHORT} steps at every C; fastest C {fastest}, the "
                f"wrapper picks {vco._cluster_size(n, k, num_sms)}")
    log(f"sweep window: {clocks.summary()}")
    for C in vco.CLUSTER_SIZES:
        us = {name: np.mean(results[name][C]) / CHUNK * 1e3
              for name in ("full width", "floor")}
        log(f"per-step time at C={C}: n={N_NEURONS} "
            f"{us['full width']:.4f} us, n={FLOOR_NEURONS} (the floor) "
            f"{us['floor']:.4f} us: {us['full width'] - us['floor']:.4f} us "
            f"a step grows with the neurons")
    return results


def main_path(fpi, vco, space, first_kernel, first_plain):
    """bench.py --model pi-fast's traffic through the user entry points.
    The warm-up chunk is the chunk check_kernel ran at the wrapper's C: it
    must match that kernel launch (max-abs <= SHORT_TOL) and agree with the
    plain version's trace of it (median |diff| <= LONG_MEDIAN_TOL).
    Returns the launches and the whole trace (CHUNK + TIMED, d)."""
    vels = traffic()
    reset_vco_launches()
    t0 = time.perf_counter()
    warm = fpi.run(vels[:CHUNK])
    log(f"warm-up chunk: {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    before = nvidia_smi(ClockSampler.QUERY)
    t0 = time.perf_counter()
    outs = fpi.run(vels[CHUNK:], transfer=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = nvidia_smi(ClockSampler.QUERY)
    launches = vco_launches()
    log(f"main path: {TIMED} steps in {seconds:.4f} s = "
        f"{TIMED / seconds:.0f} steps/s; vco_scan launches {launches}")
    log(f"main-path window ({ClockSampler.QUERY}): just before "
        f"{before}; just after {after}")
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    same = float(np.abs(warm - first_kernel.cpu().numpy()).max())
    log(f"main path's first chunk vs the same kernel launch: max-abs "
        f"{same:.3e} (tol {SHORT_TOL})")
    if not same <= SHORT_TOL:
        raise AssertionError(f"the main path's first chunk differs from the "
                             f"kernel launch on its inputs: {same}")
    check_long(space, warm, first_plain,
               f"main path's first chunk vs plain, {CHUNK} steps")
    out = torch.cat(outs).cpu().numpy()
    if out.shape != (TIMED, fpi.d) or not np.all(np.isfinite(out)):
        raise AssertionError(f"main-path output is not finite (T, d): "
                             f"{out.shape}")
    return launches, np.concatenate([warm, out])


def whole_run(vco, fpi, space, chosen, trace):
    """The main path's CHUNK + TIMED steps again, chunk by chunk through the
    kernel at the other cluster size: median |diff| and decoded-position
    difference at every chunk end."""
    other = 1 if chosen != 1 else 4
    vel = torch.tensor(traffic(), device="cuda")
    corr = torch.zeros((CHUNK, fpi.d), dtype=torch.float32, device="cuda")
    state = fpi.initial_state()
    ends, worst = [], 0.0
    for lo in range(0, CHUNK + TIMED, CHUNK):
        state, y = vco._vco_scan_cuda(fpi.params, state, vel[lo:lo + CHUNK],
                                      corr, cluster=other)
        y = y.cpu().numpy()
        ref = trace[lo:lo + CHUNK]
        med = float(np.median(np.abs(y - ref)))
        dist = float(np.linalg.norm(decode(space, y[-1]) -
                                    decode(space, ref[-1])))
        ends.append(dist)
        worst = max(worst, dist)
        log(f"whole run, C={chosen} vs C={other}, steps {lo}..{lo + CHUNK}: "
            f"median |diff| {med:.3e}, decoded position difference at the "
            f"chunk end {dist:.4f} (tol {DRIFT_TOL})")
    if not worst <= DRIFT_TOL:
        raise AssertionError(f"whole run: C={chosen} and C={other} decode "
                             f"{worst} apart > {DRIFT_TOL}")
    return other, ends


def accuracy(space_cls, fpi_cls):
    """tests/test_pallas.py::test_integration_accuracy at full width."""
    space = make_space(space_cls)
    d = space.ssp_dim
    v = np.array([0.2, -0.1])
    scale = 1 / np.max(np.abs(space.phase_matrix @ v.reshape(2, 1)))
    T = 800
    vels = np.tile(v * scale, (T, 1)).astype(np.float32)
    corr = np.zeros((T, d), np.float32)
    corr[:50] = space.encode(np.zeros((1, 2))).ravel()
    fpi = fpi_cls(space, N_NEURONS, seed=3, scaling_factor=scale,
                  chunk_steps=200, device="cuda")
    out = fpi.run(vels, corr)
    dec = space.decode(out[-1][None, :], num_samples=50, device="cuda")
    err = float(np.linalg.norm(dec - v * T * 0.001))
    log(f"constant-velocity decode error after {T} steps: {err:.4f} "
        f"(tol {ACCURACY_TOL})")
    if not err < ACCURACY_TOL:
        raise AssertionError(f"integration error {err} >= {ACCURACY_TOL}")


def pi_simulator(space, vels, scaling_factor=1.0, corrections=None,
                 seed=SEED):
    """``bench.py --model pi``'s network on the port's Simulator: the
    velocity table into PathIntegration (LIF), the output probed through a
    50 ms lowpass; ``corrections`` (T, d) feed the SSP input if given."""
    from sspslam_tpu_torch.models import PathIntegration
    from sspslam_tpu_torch.nef import (Connection, Network, Node, Probe,
                                       Simulator, TimeTable)
    with Network(seed=seed) as net:
        vel = Node(TimeTable(vels))
        pi = PathIntegration(space, N_NEURONS, 0.05,
                             scaling_factor=scaling_factor)
        Connection(vel, pi.velocity_input, synapse=None)
        if corrections is not None:
            Connection(Node(TimeTable(corrections)), pi.input, synapse=None)
        probe = Probe(pi.output, synapse=0.05)
    return Simulator(net, seed=seed, device="cuda"), probe


def timed_run(sim, probe, steps=TIMED, warm=CHUNK):
    """One ``warm``-step warm-up segment (graph capture included), then
    ``steps`` timed steps in CHUNK-step segments; returns (steps/s, the
    whole trace, the card's clocks and power just before and just after
    the timed window)."""
    sim.reset()
    sim.preload_inputs(warm + steps)
    sim.run_steps(warm, segment_steps=warm)
    sim.sync()
    before = nvidia_smi(ClockSampler.QUERY)
    t0 = time.perf_counter()
    sim.run_steps(steps, segment_steps=CHUNK)
    sim.sync()
    rate = steps / (time.perf_counter() - t0)
    return rate, sim.data[probe], [before, nvidia_smi(ClockSampler.QUERY)]


def profile_steps(sim, eager):
    """CUDA kernels and device busy time per step over PROFILE_STEPS steps
    (one torch.profiler pass after a warm-up, read by
    ``experiments.device_time_probe.profile_steps``): kernels, device
    events and busy us per step, the busy share of the profiled window,
    and the six kernels that took the most device time (name, us and
    calls per step)."""
    from sspslam_tpu_torch.experiments.device_time_probe import \
        profile_steps as profiled
    sim.reset()
    sim.loop.eager = eager
    sim.preload_inputs(2 * PROFILE_STEPS)
    sim.run_steps(PROFILE_STEPS, segment_steps=PROFILE_STEPS)
    sim.sync()

    def run():
        sim.run_steps(PROFILE_STEPS, segment_steps=PROFILE_STEPS)
        sim.sync()
    p = profiled(run, PROFILE_STEPS)
    sim.loop.eager = False
    top = [(name[:80], us, calls) for name, us, calls in p["top"]]
    return (p["kernels_per_step"], p["events_per_step"],
            p["busy_us_per_step"], p["busy_share"], top)


def simulator_path(space, vco, fast_trace):
    """Phase 8: the generic engine at full width on bench.py --model pi's
    traffic.  Returns the numbers of the Simulator's JSON line."""
    vels = traffic()
    t0 = time.perf_counter()
    sim, probe = pi_simulator(space, vels)
    n = sum(be.k * be.n if be.batched else be.n for be in sim.model.ensembles)
    log(f"Simulator build (d={space.ssp_dim}, {n} neurons): "
        f"{time.perf_counter() - t0:.1f} s")

    replay_err, _ = replay_vs_eager(sim, probe, "Simulator")

    k_eager, ev_eager, busy_eager, share_eager, _ = profile_steps(sim, True)
    k_graph, _, busy_graph, share_graph, top = profile_steps(sim, False)
    log(f"Simulator profile over {PROFILE_STEPS} steps: eager {k_eager:.2f} "
        f"kernels per step ({ev_eager:.2f} device events), device busy "
        f"{busy_eager:.1f} us per step = {share_eager * 100:.1f} % of the "
        f"profiled wall time; graph replay {k_graph:.2f} kernels per step, "
        f"busy {busy_graph:.1f} us per step = {share_graph * 100:.1f} %")
    for name, us, calls in top:
        log(f"  graph replay, per step: {us:6.2f} us in {calls:.2f} x {name}")

    # steps/s: graphs of U steps, then eager; the main path's window
    rates, first = {}, None
    reset_vco_launches()
    for U in GRAPH_UNITS:
        sim.loop.graph_steps = U
        rates[U], trace, _ = timed_run(sim, probe)
        log(f"Simulator, graphs of {U} steps: {rates[U]:.0f} steps/s over "
            f"{TIMED} steps")
        if first is None:
            first = trace
        elif not np.array_equal(trace, first):
            raise AssertionError(f"the trace with graphs of {U} steps "
                                 f"differs from the first")
    launches = vco_launches()
    if launches != 0:
        raise AssertionError(f"the Simulator path launched vco_scan "
                             f"{launches} times")
    best = max(rates, key=rates.get)
    sim.loop.graph_steps = best
    sim.loop.eager = True
    eager_rate, _, _ = timed_run(sim, probe, EAGER_TIMED, EAGER_WARM)
    sim.loop.eager = False
    log(f"Simulator, eager: {eager_rate:.0f} steps/s over {EAGER_TIMED} "
        f"steps; "
        f"fastest graph length {best} steps")

    # against the fast path's trace of the same velocities (phase 5)
    if first.shape != fast_trace.shape or not np.all(np.isfinite(first)):
        raise AssertionError(f"Simulator trace {first.shape} is not finite "
                             f"or not the fast path's shape "
                             f"{fast_trace.shape}")
    ends = []
    for lo in range(0, CHUNK + TIMED, CHUNK):
        a, b = first[lo:lo + CHUNK], fast_trace[lo:lo + CHUNK]
        dist = float(np.linalg.norm(decode(space, a[-1]) - decode(space, b[-1])))
        ends.append(dist)
        log(f"Simulator vs fast path, steps {lo}..{lo + CHUNK}: median "
            f"|diff| {float(np.median(np.abs(a - b))):.3e}, decoded position "
            f"difference at the chunk end {dist:.4f} (tol {DRIFT_TOL})")
    if not max(ends) <= DRIFT_TOL:
        raise AssertionError(f"Simulator and fast path decode {max(ends)} "
                             f"apart > {DRIFT_TOL}")
    return {"neurons": n, "graph_vs_eager_max_abs": replay_err,
            "steps_per_s_by_graph_steps": {str(U): r
                                           for U, r in rates.items()},
            "graph_steps_fastest": best, "steps_per_s_eager": eager_rate,
            "kernels_per_step_eager": k_eager,
            "kernels_per_step_graph": k_graph,
            "device_busy_us_per_step_eager": busy_eager,
            "device_busy_share_eager": share_eager,
            "device_busy_us_per_step_graph": busy_graph,
            "device_busy_share_graph": share_graph,
            "top_kernels_graph": top,
            "vco_scan_launches": launches,
            "vs_fast_path_decoded_diff": ends}


def _semantics_net(nef):
    """A PES network of rate neurons with a subsampled dense probe and a
    sparse weights probe: every kind of bookkeeping the Simulator does."""
    tab = np.sin(np.linspace(0, 8, 700, dtype=np.float32))[:, None]
    with nef.Network(seed=0) as net:
        inp = nef.Node(nef.TimeTable(tab))
        a = nef.Ensemble(60, 1, neuron_type=nef.LIFRate())
        out = nef.Node(size_in=1)
        nef.Connection(inp, a, synapse=None)
        c = nef.Connection(a, out, function=lambda x: x * 0,
                           learning_rule_type=nef.PES(1e-3), synapse=0.01)
        nef.Connection(inp, c.learning_rule, transform=-1, synapse=0.005)
        nef.Connection(out, c.learning_rule, synapse=0.005)
        dense = nef.Probe(out, synapse=0.01, sample_every=0.007)
        sparse = nef.Probe(c, attr="weights", sample_every=0.1)
    return net, (dense, sparse)


def simulator_semantics():
    """The Simulator's bookkeeping through CUDA graphs against the same
    network stepped eagerly on the CPU, with the same calls: runs of
    130, 170 and 333 steps in segments of 64 (graph remainders, sparse
    clips, the global thinning phase), inputs streamed and then preloaded,
    the learning rate zeroed in place between runs (no recapture), and a
    checkpoint of the card's run continued on the CPU.  Returns the
    largest difference, relative to max(|probe|, 1)."""
    import tempfile
    from sspslam_tpu_torch import nef
    worst = 0.0

    def make(device):
        net, probes = _semantics_net(nef)
        return nef.Simulator(net, seed=0, device=device), probes

    def compare(card, host, what, rows=None):
        nonlocal worst
        for pc, ph in zip(card[1], host[1]):
            y = host[0].data[ph]
            x = card[0].data[pc][-len(y):] if rows == "tail" \
                else card[0].data[pc]
            if x.shape != y.shape:
                raise AssertionError(f"{what}: shapes {x.shape}, {y.shape}")
            err = float(np.abs(x - y).max()) / max(float(np.abs(y).max()), 1)
            worst = max(worst, err)
            if not err <= 1e-4:
                raise AssertionError(f"{what}: card vs CPU {err}")

    for preload in (False, True):
        pair = [make("cuda"), make("cpu")]
        for sim, _ in pair:
            if preload:
                sim.preload_inputs(633)
            sim.run_steps(130, segment_steps=64)
            sim.run_steps(170, segment_steps=64)
            slot = next(bc.learned_slot for bc in sim.model.connections
                        if bc.pes_rule is not None)
            sim.params["hyper"]["lr"][slot].zero_()
            sim.run_steps(333, segment_steps=64)
        compare(*pair, f"semantics, preload={preload}")
        weights = pair[0][0].data[pair[0][1][1]]   # steps 100, 200, ... 600
        if not np.array_equal(weights[-1], weights[-4]):
            raise AssertionError("a zeroed learning rate still learned")
    card, host = make("cuda"), make("cpu")
    card[0].run_steps(250, segment_steps=64)
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "ck.npz")
        card[0].save_checkpoint(ck)
        host[0].load_checkpoint(ck)
    for sim, _ in (card, host):
        sim.run_steps(150, segment_steps=64)
    compare(card, host, "checkpoint continued", rows="tail")
    log(f"Simulator semantics, card (graphs) vs CPU (eager): largest "
        f"difference {worst:.3e} (tol 1e-4)")
    return worst


def simulator_accuracy(space_cls):
    """Phase 9: the constant-velocity gate of phase 7 through the
    Simulator."""
    space = make_space(space_cls)
    v = np.array([0.2, -0.1])
    scale = 1 / np.max(np.abs(space.phase_matrix @ v.reshape(2, 1)))
    T = 800
    vels = np.tile(v * scale, (T, 1)).astype(np.float32)
    corr = np.zeros((T, space.ssp_dim), np.float32)
    corr[:50] = space.encode(np.zeros((1, 2))).ravel()
    sim, probe = pi_simulator(space, vels, scaling_factor=scale,
                              corrections=corr, seed=3)
    sim.run_steps(T)
    out = sim.data[probe]
    dec = space.decode(out[-1][None, :], num_samples=50, device="cuda")
    err = float(np.linalg.norm(dec - v * T * 0.001))
    log(f"Simulator: constant-velocity decode error after {T} steps: "
        f"{err:.4f} (tol {ACCURACY_TOL})")
    if not err < ACCURACY_TOL:
        raise AssertionError(f"Simulator integration error {err} >= "
                             f"{ACCURACY_TOL}")
    return err


# Runs a CLI module as ``python -m`` does (runpy, as __main__), then prints
# the VCO kernel's launch count of that process.
_COUNTED_CLI = """
import runpy, sys
name, sys.argv = sys.argv[1], sys.argv[1:]
from sspslam_tpu_torch.utils import profiling
runpy.run_module(name, run_name="__main__", alter_sys=True)
print(f"vco_scan launches: {profiling.counter('vco_scan.launches')}")
"""


def start_counted(name, *args, env=None):
    """Start ``sspslam_tpu_torch.experiments.<name>`` with ``args``, run
    as ``python -m`` runs it, in a child that then prints the VCO kernel's
    launches (``env``: variables added to the child's environment); its
    output goes to temporary files.  Returns (name, process, stdout file,
    stderr file, start time) for ``counted_result``."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", _COUNTED_CLI,
         f"sspslam_tpu_torch.experiments.{name}", *args],
        cwd=Path(__file__).resolve().parent, stdout=out, stderr=err,
        text=True, env=dict(os.environ, **(env or {})))
    return name, proc, out, err, time.perf_counter()


def counted_result(child, end):
    """A finished child of ``start_counted`` that ended at ``end``
    (perf_counter): it must have exited 0 and launched the VCO kernel 0
    times (these CLIs step the Simulator or batched episodes).  Logs its
    lines; returns its standard output, seconds and launches."""
    name, proc, out, err, t0 = child
    out.seek(0)
    stdout = out.read()
    for line in stdout.splitlines():
        if not line.startswith("  sim "):
            log(f"  {name}: {line.strip()[:400]}")
    if proc.returncode != 0:
        err.seek(0)
        raise AssertionError(f"{name} exited {proc.returncode}: "
                             f"{err.read()[-2000:]}")
    line = next(l for l in stdout.splitlines()
                if l.startswith("vco_scan launches:"))
    launches = int(line.split()[-1])
    if launches != 0 and name not in KERNEL_CHILDREN:
        raise AssertionError(f"{name} launched vco_scan: {line}")
    return stdout, end - t0, launches


#: children that launch the VCO kernel themselves (phase 35 compares the
#: ranks' sharded scan with the unsharded kernel in its own process)
KERNEL_CHILDREN = {"mesh"}


def start_script(script, *args):
    """Start the repository's ``script`` with ``args`` in a child (its
    last line must be the VCO kernel's launches in that process), as
    ``start_counted`` starts a CLI."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    root = Path(__file__).resolve().parent
    proc = subprocess.Popen([sys.executable, str(root / script), *args],
                            cwd=root, stdout=out, stderr=err, text=True)
    return script, proc, out, err, time.perf_counter()


def start_together(jobs, envs=None):
    """``jobs`` ({key: (name, *args)}) started at once by
    ``start_counted`` (``envs``: {key: environment variables}); returns
    the children for ``wait_together``."""
    return {key: (key,) + start_counted(
        *job, env=(envs or {}).get(key))[1:] for key, job in jobs.items()}


def wait_together(children, timeout):
    """Children of ``start_together`` waited for together (each killed if
    the whole takes over ``timeout`` s from now or another fails first);
    {key: counted_result}, each child's lines logged under its key."""
    results = {}
    try:
        deadline = time.perf_counter() + timeout
        while len(results) < len(children):
            for key, child in children.items():
                if key not in results and child[1].poll() is not None:
                    results[key] = counted_result(child, time.perf_counter())
            if time.perf_counter() > deadline:
                raise AssertionError(f"children still running after "
                                     f"{timeout} s: "
                                     f"{sorted(set(children) - set(results))}")
            time.sleep(0.1)
        return {key: results[key] for key in children}
    finally:
        stop_children(children)


def stop_children(children):
    """Kill every child of ``start_together`` that still runs."""
    for _, proc, *_ in children.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_together(jobs, timeout=600, envs=None):
    """``jobs`` started at once and waited for together
    (``start_together``, ``wait_together``)."""
    return wait_together(start_together(jobs, envs), timeout)


def run_counted(name, *args, timeout=600):
    """One ``start_counted`` child, waited for: its ``counted_result``."""
    return run_together({name: (name, *args)}, timeout)[name]


def cli_errors(name, stdout, seconds, launches):
    """Phases 10, 13 and 18: a ``counted_result`` whose child must have
    printed finite errors.  Returns the final and median errors, the
    seconds and the launches the child printed."""
    line = next(l for l in stdout.splitlines()
                if l.startswith("final distance error"))
    final, median = (float(x) for x in
                     line.replace(";", "").split()[3::2])
    if not (np.isfinite(final) and np.isfinite(median)):
        raise AssertionError(f"{name} printed {line!r}")
    log(f"{name}: exit 0 in {seconds:.1f} s; final error {final}, "
        f"median {median} (printed, not gated)")
    return {"final_error": final, "median_error": median,
            "seconds": seconds, "vco_scan_launches": launches}


def untimed_jobs():
    """Phases 10, 13 and 18, 23's ``train_slam`` runs and sweep, 25's
    ``serving_probe`` and 26's ``run_slam --backend numpy``: the CLI
    children whose times the smoke does not report as readings (they run
    beside one another); ({key: (name, *args)}, {key: environment
    variables})."""
    jobs = {
        "run_pathint": ("run_pathint",),
        "run_slam": ("run_slam", "--T", "20"),
        "run_slamview": ("run_slamview", "--T", "20"),
        "run_slam_gated": ("run_slam", "--backend", "gated", "--T", "20"),
        "tune_loop_closure": ("tune_loop_closure", *TUNE_ARGS),
        "train_slam_meta_cuda": ("train_slam", *META_ARGS),
        "train_slam_meta_cpu": ("train_slam", *META_ARGS, "--device", "cpu"),
        "serving_probe": ("serving_probe", *SERVING_PROBE_ARGS),
        "run_slam_numpy": ("run_slam", *NUMPY_SLAM_ARGS),
        "train_slam": ("train_slam", *SLAM_TRAIN_ARGS)}
    envs = {"train_slam_meta_cuda": META_ENV,
            "train_slam_meta_cpu": dict(META_ENV, OMP_NUM_THREADS="1"),
            "run_slam_numpy": {"OMP_NUM_THREADS": "1"}}
    return jobs, envs


def children_and_checks(vco, work, ref):
    """``untimed_jobs``' children and phases 28-30's CLIs
    (``new_cli_jobs``) run together after phase 17, while this process
    runs phases 28-30's own checks, none of them timed
    (``recovery_schedule``, ``maps_in_process``, ``flagship_mflop``),
    phase 32's demos (``demos_phase``: their steps/s are taken beside the
    children) and phase 34's SLAM worlds against the JAX reference ``ref``
    (``reference_slam``); ``work`` is the directory the CLIs write their
    files into.  Returns ({key: counted_result}, the five checks'
    results)."""
    jobs, envs = untimed_jobs()
    t0 = time.perf_counter()
    pending = start_together({**jobs, **new_cli_jobs(work)}, envs)
    pending["mesh"] = ("mesh",) + start_script(
        "tests/torch_card_sharded.py", "--smoke")[1:]
    try:
        checks = (recovery_schedule(vco), maps_in_process(vco),
                  flagship_mflop(vco), demos_phase(vco, ref),
                  reference_slam(ref, vco))
        children = wait_together(pending, timeout=1000)
    except BaseException:
        stop_children(pending)
        raise
    log(f"{len(children)} CLI children together, beside phases 28-30's, "
        f"32's and 34's checks: {time.perf_counter() - t0:.1f} s")
    return children, checks


def mesh_phase(child):
    """Phase 35's numbers from its child (``tests/torch_card_sharded.py
    --smoke``): the world it ran, one ``vco_scan`` launch a rank a chunk,
    the collectives a step, the dry run's bundle step and the full-width
    bundle: one program a model coordinate, as many all-reduces in each as
    the live step, served rows within 1e-6 of the live ones on every rank,
    no ``vco_scan`` launch in the ranks' live and served SLAM;
    the child itself held the sharded rows to the unsharded Simulator's
    and the shards' scan to the unsharded kernel."""
    stdout, seconds, _ = child
    mesh = json.loads(next(l for l in stdout.splitlines()
                           if l.startswith('{"mesh"')))["mesh"]
    run = mesh["runs"][0]
    world = min(4, torch.cuda.device_count())
    per = run["vco_launches_per_rank_per_chunk"]
    if not (run["world"] == world == mesh["dryrun"]["world"]
            and len(per) == world and all(n == 1 for p in per for n in p)):
        raise AssertionError(f"phase 35: world {run['world']} (want "
                             f"{world}), vco_scan launches {per}")
    dry, b = mesh["dryrun"]["bundle"], run["bundle"]
    served = b["served_max_abs_vs_live"]
    if not (dry["programs"] == world == b["programs"]
            and dry["all_reduces_per_step"]
            == mesh["dryrun"]["all_reduces_per_step"]
            and b["program_all_reduces"] == run["all_reduces_per_step"]
            and len(served) == world and max(served) <= 1e-6
            and b["vco_scan_launches"] == [0] * world):
        raise AssertionError(f"phase 35: bundle {b}, dry run's {dry}")
    mesh["seconds"] = seconds
    log(f"mesh (phase 35): world {world} under NCCL; dry run "
        f"{mesh['dryrun']['all_reduces_per_step']} all-reduces a step, "
        f"FLOP ratio {mesh['dryrun']['flops_ratio_to_ideal']:.3f}, bundle "
        f"of {dry['programs']} programs served; full width "
        f"{run['all_reduces_per_step']} all-reduces a step "
        f"({run['all_reduce_bytes_per_step']} bytes), first rows median "
        f"{run['first_rows']['median']:.2e} vs unsharded; bundle "
        f"{b['programs']} programs of {b['program_all_reduces']} "
        f"all-reduces, export {b['export_s']:.1f} s, {b['mb']:.2f} MB, "
        f"served vs live max-abs {max(served):.2e} over "
        f"{run['steps']} steps, served {b['served_steps_per_s']:.1f} vs "
        f"live {b['live_steps_per_s']:.1f} steps/s, vco_scan launches "
        f"live and served {b['vco_scan_launches']}; vco_scan launches a "
        f"rank a chunk {per}; {seconds:.1f} s")
    return mesh


def replay_vs_eager(sim, probe, what):
    """Graph replay against the eager step over LONG steps from the fresh
    state; returns the max-abs difference of the probe traces and the
    eager run's steps/s."""
    traces = {}
    for eager in (False, True):
        sim.reset()
        sim.loop.eager = eager
        sim.preload_inputs(LONG)
        t0 = time.perf_counter()
        sim.run_steps(LONG, segment_steps=LONG)
        sim.sync()
        eager_rate = LONG / (time.perf_counter() - t0)
        traces[eager] = sim.data[probe]
    sim.loop.eager = False
    err = float(np.abs(traces[False] - traces[True]).max())
    log(f"{what}: graph replay vs eager step, {LONG} steps: max-abs "
        f"{err:.3e} (tol {REPLAY_TOL}); eager {eager_rate:.0f} steps/s")
    if not (np.all(np.isfinite(traces[False])) and err <= REPLAY_TOL):
        raise AssertionError(f"{what}: graph replay differs from the eager "
                             f"step: {err}")
    return err, eager_rate


def tracking_cosine(space, out, path):
    """bench.py's sanity metric (``sspslam_tpu_torch.bench``'s): the mean
    over the last quarter of the world of cos(PI output, encode(path)),
    the output's norm only."""
    from sspslam_tpu_torch.bench import tracking_cosine as cosine
    return cosine(space, out, path)


def hoisted_threshold(sim, probe):
    """An in-place change of a hoisted threshold (the gate's shift_rate set
    to 0) changes the next graph replay, with no new capture: from one
    saved state, SHIFT_STEPS replayed steps at the built shift_rate, then
    with shift_rate 0, then eagerly with 0 (the replay must equal it).
    Returns (max-abs of the first two, max-abs of the last two)."""
    from sspslam_tpu_torch.nef.simulator import _flatten
    key = next(k for k, h in sim.params["hoisted"].items()
               if "shift_rate" in h)
    rate = sim.params["hoisted"][key]["shift_rate"]
    built = rate.clone()
    leaves = _flatten(sim.state)
    saved = [x.clone() for x in leaves]
    sim.preload_inputs(SHIFT_STEPS)
    traces, graphs = [], None
    for value, eager in ((None, False), (0.0, False), (0.0, True)):
        for x, s in zip(leaves, saved):
            x.copy_(s)
        sim._preload_start = sim.n_steps   # replay the same input rows
        if value is not None:
            rate.fill_(value)
        sim.loop.eager = eager
        sim.run_steps(SHIFT_STEPS, segment_steps=SHIFT_STEPS)
        traces.append(sim.data[probe][-SHIFT_STEPS:])
        if graphs is None:
            graphs = dict(sim.loop.graphs)
        elif not eager and {k: id(g) for k, g in sim.loop.graphs.items()} != \
                {k: id(g) for k, g in graphs.items()}:
            raise AssertionError("changing a hoisted threshold recaptured "
                                 "the graphs")
    sim.loop.eager = False
    rate.copy_(built)
    moved = float(np.abs(traces[0] - traces[1]).max())
    same = float(np.abs(traces[1] - traces[2]).max())
    log(f"SLAM: shift_rate {float(built):g} -> 0 in place: the next "
        f"{SHIFT_STEPS} replayed steps move by max-abs {moved:.3e}, no new "
        f"capture; replay vs eager at 0: max-abs {same:.3e} (tol "
        f"{REPLAY_TOL})")
    if not (moved > 1e-3 and same <= REPLAY_TOL):
        raise AssertionError(f"shift_rate in place: moved {moved}, replay "
                             f"vs eager {same}")
    return moved, same


def slam_path(space, vco):
    """Phases 11 and 12: SLAMNetwork at full width on bench.py --model
    slam's traffic through the Simulator.  Returns the numbers of the SLAM
    JSON line."""
    from sspslam_tpu_torch.experiments.common import slam_world, slam_simulator
    from sspslam_tpu_torch.utils.profiling import print_utilization_summary
    world = slam_world()
    path = world[0]
    reset_vco_launches()
    sim, probe, build_s = slam_simulator(space, world)
    n = sum(be.k * be.n if be.batched else be.n for be in sim.model.ensembles)
    log(f"SLAM build (d={space.ssp_dim}, {n} neurons): {build_s:.1f} s")
    rows = print_utilization_summary(sim.model)
    out = {"neurons": n, "build_s": build_s,
           "flops_per_step": float(sum(r["flops_per_step"] for r in rows))}

    # (a) graph replay vs eager
    out["graph_vs_eager_max_abs"], out["steps_per_s_eager"] = \
        replay_vs_eager(sim, probe, "SLAM")

    # (b) kernels per step
    k_eager, ev_eager, busy_eager, share_eager, _ = profile_steps(sim, True)
    k_graph, _, busy_graph, share_graph, top = profile_steps(sim, False)
    log(f"SLAM profile over {PROFILE_STEPS} steps: eager {k_eager:.2f} "
        f"kernels per step ({ev_eager:.2f} device events), device busy "
        f"{busy_eager:.1f} us per step = {share_eager * 100:.1f} % of the "
        f"profiled wall time; graph replay {k_graph:.2f} kernels per step, "
        f"busy {busy_graph:.1f} us per step = {share_graph * 100:.1f} %")
    for name, us, calls in top:
        log(f"  SLAM graph replay, per step: {us:6.2f} us in {calls:.2f} x "
            f"{name}")
    out.update(kernels_per_step_eager=k_eager, kernels_per_step_graph=k_graph,
               device_busy_us_per_step_eager=busy_eager,
               device_busy_us_per_step_graph=busy_graph,
               device_busy_share_graph=share_graph, top_kernels_graph=top)

    # (c) tracking over the world, in one run from the fresh state
    sim.reset()
    sim.run_steps(WORLD_STEPS)
    trace = sim.data[probe]
    cos = tracking_cosine(space, trace, path)
    log(f"SLAM tracking cosine (last quarter of the {WORLD_STEPS}-step "
        f"world): {cos:.4f} (gate >= {TRACKING_GATE})")
    if not (trace.shape == (WORLD_STEPS, space.ssp_dim)
            and np.all(np.isfinite(trace)) and cos >= TRACKING_GATE):
        raise AssertionError(f"SLAM tracking cosine {cos} < {TRACKING_GATE} "
                             f"or the trace is not finite")
    out["tracking_cosine"] = cos

    # (f) a hoisted threshold changed in place, from the tracked state
    out["shift_rate_in_place_moved"], out["shift_rate_replay_vs_eager"] = \
        hoisted_threshold(sim, probe)

    # (d) steps/s, bench.py's timing: one warm-up segment, then SIM_TIMED
    # steps
    rate, timed, window = timed_run(sim, probe, SIM_TIMED, SIM_WARM)
    log(f"SLAM: {rate:.0f} steps/s over {SIM_TIMED} steps (graphs of "
        f"{sim.loop.graph_steps} steps); window ({ClockSampler.QUERY}): just "
        f"before {window[0]}; just after {window[1]}")
    if not np.all(np.isfinite(timed)):
        raise AssertionError("SLAM timed run is not finite")
    out["steps_per_s"] = rate
    out["timed_window_nvidia_smi"] = window
    out["param_bytes"] = param_bytes(sim.params)[0]
    del sim

    # 12. the auto-recovery gate with anchors: the stateful node and the
    # in-step bind / unbind inside a captured graph
    sim, probe, build_s = slam_simulator(space, world, "auto_recovery",
                                         anchor=True)
    log(f"SLAM, auto-recovery gate with {ANCHORS} anchors: build "
        f"{build_s:.1f} s")
    out["anchor_graph_vs_eager_max_abs"], out["anchor_steps_per_s_eager"] \
        = replay_vs_eager(sim, probe, "SLAM, auto-recovery + anchor")
    del sim

    # (e) this path reaches no Pallas kernel in the JAX package
    launches = vco_launches()
    if launches != 0:
        raise AssertionError(f"the SLAM path launched vco_scan {launches} "
                             f"times")
    out["vco_scan_launches"] = launches
    return out


def n_neurons(sim):
    return sum(be.k * be.n if be.batched else be.n
               for be in sim.model.ensembles)


def profile_line(what, sim):
    """Kernels per step and device busy time, eager and replayed (one
    profiler pass each); returns the numbers for the JSON line."""
    k_eager, ev_eager, busy_eager, share_eager, _ = profile_steps(sim, True)
    k_graph, _, busy_graph, share_graph, top = profile_steps(sim, False)
    log(f"{what} profile over {PROFILE_STEPS} steps: eager {k_eager:.2f} "
        f"kernels per step ({ev_eager:.2f} device events), busy "
        f"{busy_eager:.1f} us per step = {share_eager * 100:.1f} %; graph "
        f"replay {k_graph:.2f} kernels per step, busy {busy_graph:.1f} us "
        f"per step = {share_graph * 100:.1f} %")
    for name, us, calls in top:
        log(f"  {what} graph replay, per step: {us:6.2f} us in {calls:.2f} x "
            f"{name}")
    return {"kernels_per_step_eager": k_eager,
            "kernels_per_step_graph": k_graph,
            "device_busy_us_per_step_eager": busy_eager,
            "device_busy_us_per_step_graph": busy_graph,
            "device_busy_share_graph": share_graph, "top_kernels_graph": top}


def full_checks(what, sim, probe, space, path, build_s, steps=SIM_TIMED):
    """Phases 14 and 15 (and 16's direct-optim): the neuron count and build
    time; graph replay against eager over LONG steps; kernels per step;
    the tracking cosine over one run of the world (printed, finite, not
    gated); steps/s over ``steps`` timed steps after one CHUNK-step
    warm-up, the card's clocks and power read just before and after."""
    out = {"neurons": n_neurons(sim), "build_s": build_s}
    log(f"{what} build (d={space.ssp_dim}, {out['neurons']} neurons): "
        f"{build_s:.1f} s")
    out["graph_vs_eager_max_abs"], out["steps_per_s_eager"] = \
        replay_vs_eager(sim, probe, what)
    out.update(profile_line(what, sim))
    if path is not None:
        sim.reset()
        sim.run_steps(WORLD_STEPS)
        trace = sim.data[probe]
        cos = tracking_cosine(space, trace, path)
        log(f"{what} tracking cosine (last quarter of the {WORLD_STEPS}-step "
            f"world): {cos:.4f} (printed, not gated)")
        if not (trace.shape == (WORLD_STEPS, space.ssp_dim)
                and np.all(np.isfinite(trace)) and np.isfinite(cos)):
            raise AssertionError(f"{what}: the world's trace is not finite")
        out["tracking_cosine"] = cos
    rate, timed, window = timed_run(sim, probe, steps, SIM_WARM)
    log(f"{what}: {rate:.0f} steps/s over {steps} steps (graphs of "
        f"{sim.loop.graph_steps} steps); window ({ClockSampler.QUERY}): just "
        f"before {window[0]}; just after {window[1]}")
    if not np.all(np.isfinite(timed)):
        raise AssertionError(f"{what}: the timed run is not finite")
    out["steps_per_s"] = rate
    out["timed_window_nvidia_smi"] = window
    return out


def gated_simulator(space, world):
    """Phase 14's network: SLAMGatedNetwork at full width (800 LIF per VCO,
    memory 970, 100 neurons per circular-convolution dimension and for the
    dot product) on bench.py --model slam's traffic through the
    single-nearest adapter, the PI output probed through a 50 ms
    lowpass."""
    from sspslam_tpu_torch import SPSpace
    from sspslam_tpu_torch.models import (SLAMGatedNetwork,
                                          get_slam_input_functions)
    from sspslam_tpu_torch.nef import (Connection, Network, Node, Probe,
                                       Simulator, clamp_table)
    path, vels, landmarks, vec = world
    lm_space = SPSpace(SLAM_LANDMARKS, space.ssp_dim, seed=SEED)
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions(space, lm_space, vels, vec, VIEW_RAD)
    with Network(seed=SEED) as net:
        slam = SLAMGatedNetwork(
            space, lm_space, VIEW_RAD, SLAM_LANDMARKS,
            pi_n_neurons=N_NEURONS, mem_n_neurons=970,
            circonv_n_neurons=100, dotprod_n_neurons=100,
            vel_scaling_factor=scale, seed=SEED)
        for f, dst in ((vel_f, slam.velocity_input),
                       (clamp_table(space.encode(path[:1]).ravel(), 0.05),
                        slam.pathintegrator.input),
                       (sp_f, slam.landmark_sp_input),
                       (vecssp_f, slam.landmark_vecssp_input),
                       (in_view_f, slam.no_landmark_in_view)):
            Connection(Node(f), dst, synapse=None)
        probe = Probe(slam.pathintegrator.output, synapse=0.05)
    t0 = time.perf_counter()
    sim = Simulator(net, seed=SEED, device="cuda")
    return sim, probe, time.perf_counter() - t0


def view_simulator(space, world, gate_mode="reference", anchor=False):
    """Phase 15's network: SLAMViewNetwork at run_slamview's default widths
    (700 LIF per VCO, memory 970, grid clean-up over 100 x 100 samples)
    fed by get_slamview_input_functions on bench.py --model slam's world;
    with ``anchor`` the auto-recovery gate reads the first ANCHORS
    landmarks as surveyed beacons."""
    from sspslam_tpu_torch import SPSpace
    from sspslam_tpu_torch.models import (SLAMViewNetwork,
                                          get_anchor_input_functions,
                                          get_slamview_input_functions)
    from sspslam_tpu_torch.nef import (Connection, Network, Node, Probe,
                                       Simulator, clamp_table)
    path, vels, landmarks, vec = world
    lm_space = SPSpace(SLAM_LANDMARKS, space.ssp_dim, seed=SEED)
    vel_f, scale, in_view_f, view_f = get_slamview_input_functions(
        space, lm_space, vels, vec, VIEW_RAD)
    with Network(seed=SEED) as net:
        slam = SLAMViewNetwork(
            space, lm_space, VIEW_RAD, SLAM_LANDMARKS, pi_n_neurons=700,
            mem_n_neurons=970, circonv_n_neurons=100,
            vel_scaling_factor=scale, cleanup_samples_per_dim=100,
            seed=SEED, gate_mode=gate_mode, anchor=anchor)
        for f, dst in ((vel_f, slam.velocity_input),
                       (clamp_table(space.encode(path[:1]).ravel(), 0.05),
                        slam.pathintegrator.input),
                       (view_f, slam.view_input),
                       (in_view_f, slam.no_landmark_in_view)):
            Connection(Node(f), dst, synapse=None)
        if anchor:
            tables = get_anchor_input_functions(
                space, vec, np.arange(ANCHORS), landmarks[:ANCHORS],
                VIEW_RAD)
            for f, dst in zip(tables, (slam.anchor_pos_input,
                                       slam.anchor_vec_ssp,
                                       slam.no_anchor_in_view)):
                Connection(Node(f), dst, synapse=None)
        probe = Probe(slam.pathintegrator.output, synapse=0.05)
    t0 = time.perf_counter()
    sim = Simulator(net, seed=SEED, device="cuda")
    return sim, probe, time.perf_counter() - t0


def family_models(space, vco):
    """Phases 14 and 15: SLAMGatedNetwork and SLAMViewNetwork at full width
    on bench.py --model slam's world; the VCO kernel launches 0 times."""
    from sspslam_tpu_torch.experiments.common import slam_world
    world = slam_world()
    reset_vco_launches()
    out = {}
    sim, probe, build_s = gated_simulator(space, world)
    out["gated"] = full_checks("SLAMGatedNetwork", sim, probe, space,
                               world[0], build_s)
    out["gated"]["vco_scan_launches"] = vco_launches()
    del sim
    reset_vco_launches()
    sim, probe, build_s = view_simulator(space, world)
    out["view"] = full_checks("SLAMViewNetwork", sim, probe, space,
                              world[0], build_s)
    del sim
    sim, probe, build_s = view_simulator(space, world, "auto_recovery",
                                         anchor=True)
    log(f"SLAMViewNetwork, auto-recovery gate with {ANCHORS} anchors: build "
        f"{build_s:.1f} s")
    out["view"]["anchor_graph_vs_eager_max_abs"], \
        out["view"]["anchor_steps_per_s_eager"] = replay_vs_eager(
            sim, probe, "SLAMViewNetwork, auto-recovery + anchor")
    out["view"]["vco_scan_launches"] = vco_launches()
    del sim
    for name in ("gated", "view"):
        if out[name]["vco_scan_launches"] != 0:
            raise AssertionError(f"the {name} path launched vco_scan")
    return out


DECODE_POINTS = 1_000
CLEANUP_TIMED = 5_000    # direct-optim's timed steps (one warm-up segment)


def cleanup_methods(vco):
    """Phase 16: the MLP decoder trained at its defaults on the card; the
    four decode methods on DECODE_POINTS random points (direct-optim must
    decode no worse than from-set, the median error); SLAMNetwork at phase
    11's width with each Newton / MLP clean-up through the Simulator."""
    from sspslam_tpu_torch.experiments.common import slam_world, slam_simulator
    from sspslam_tpu_torch import HexagonalSSPSpace
    space = make_space(HexagonalSSPSpace)
    reset_vco_launches()
    out = {}
    t0 = time.perf_counter()
    history = space.train_decoder_net(load_file=False, save_file=False,
                                      device="cuda")
    out["train_decoder_s"] = time.perf_counter() - t0
    out["train_decoder_final_loss"] = history[-1]
    log(f"train_decoder_net at its defaults (200,000 Rd points, 20 epochs, "
        f"batch 2,048) on the card: {out['train_decoder_s']:.1f} s, final "
        f"loss {history[-1]:.5f}")
    if not np.isfinite(history[-1]) or history[-1] >= history[0]:
        raise AssertionError(f"decoder training did not learn: {history}")

    pts = np.random.default_rng(SEED).uniform(-1, 1, (DECODE_POINTS, 2))
    ssps = space.encode(pts)
    errs = {}
    for method in ("from-set", "direct-optim", "network", "network-optim"):
        t0 = time.perf_counter()
        got = space.decode(ssps, method, num_samples=100, device="cuda")
        secs = time.perf_counter() - t0
        errs[method] = float(np.median(np.linalg.norm(got - pts, axis=1)))
        log(f"decode {method}: median error {errs[method]:.3e} over "
            f"{DECODE_POINTS} points ({secs:.2f} s)")
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"decode {method} is not finite")
    if not errs["direct-optim"] <= errs["from-set"]:
        raise AssertionError(f"direct-optim decodes worse than from-set: "
                             f"{errs}")
    out["decode_median_error"] = errs

    world = slam_world()
    for method in ("direct-optim", "network", "network-optim"):
        sim, probe, build_s = slam_simulator(space, world,
                                             clean_up_method=method)
        what = f"SLAM, {method} clean-up"
        if method == "direct-optim":
            out[method] = full_checks(what, sim, probe, space, None,
                                      build_s, steps=CLEANUP_TIMED)
        else:
            log(f"{what}: build {build_s:.1f} s")
            out[method] = dict(zip(
                ("graph_vs_eager_max_abs", "steps_per_s_eager"),
                replay_vs_eager(sim, probe, what)))
        del sim
    out["vco_scan_launches"] = vco_launches()
    if out["vco_scan_launches"] != 0:
        raise AssertionError("the clean-up paths launched vco_scan")
    return out


VARIANT_STEPS = 1_000


def pi_variants(space, vco):
    """Phase 17: PathIntegrationReencode, PathIntegrationGC and
    PathIntegrationBCsGCs at ssp_dim 97 and 800 neurons per ensemble on
    bench.py --model pi's velocities from an SSP clamped at the origin:
    graph replay against eager over VARIANT_STEPS steps and the decoded
    error at the end (printed, not gated)."""
    from sspslam_tpu_torch.models import (PathIntegrationBCsGCs,
                                          PathIntegrationGC,
                                          PathIntegrationReencode)
    from sspslam_tpu_torch.nef import (Connection, Network, Node, Probe,
                                       Simulator, TimeTable, clamp_table)
    vels = traffic()[:VARIANT_STEPS]
    truth = np.cumsum(vels, axis=0)[-1] * 0.001
    makers = {
        "reencode": lambda: PathIntegrationReencode(space, N_NEURONS, 0.05),
        "gc": lambda: PathIntegrationGC(space, N_NEURONS, 0.05),
        "bcsgcs": lambda: PathIntegrationBCsGCs(space, N_NEURONS, N_NEURONS,
                                                0.05),
    }
    reset_vco_launches()
    out = {}
    for name, make in makers.items():
        with Network(seed=SEED) as net:
            pi = make()
            Connection(Node(TimeTable(vels)), pi.velocity_input,
                       synapse=None)
            Connection(Node(clamp_table(space.encode(np.zeros((1, 2)))
                                        .ravel(), 0.05)), pi.input,
                       synapse=None)
            probe = Probe(pi.output, synapse=0.05)
        t0 = time.perf_counter()
        sim = Simulator(net, seed=SEED, device="cuda")
        build_s = time.perf_counter() - t0
        traces = {}
        for eager in (False, True):
            sim.reset()
            sim.loop.eager = eager
            sim.run_steps(VARIANT_STEPS, segment_steps=VARIANT_STEPS)
            traces[eager] = sim.data[probe]
        sim.loop.eager = False
        err = float(np.abs(traces[False] - traces[True]).max())
        dec = decode(space, traces[False][-1])
        dist = float(np.linalg.norm(dec - truth))
        log(f"{name} (d={space.ssp_dim}, {n_neurons(sim)} neurons, build "
            f"{build_s:.1f} s): graph replay vs eager, {VARIANT_STEPS} "
            f"steps: max-abs {err:.3e} (tol {REPLAY_TOL}); decoded error at "
            f"the end {dist:.4f} (printed, not gated)")
        if not (np.all(np.isfinite(traces[False])) and err <= REPLAY_TOL):
            raise AssertionError(f"{name}: graph replay differs from the "
                                 f"eager step: {err}")
        out[name] = {"neurons": n_neurons(sim), "build_s": build_s,
                     "graph_vs_eager_max_abs": err,
                     "decoded_error_at_end": dist}
        del sim
    out["vco_scan_launches"] = vco_launches()
    if out["vco_scan_launches"] != 0:
        raise AssertionError("the PI variants launched vco_scan")
    return out


QUANT_TIMED = 2_000      # timed steps of each quantised SLAM (phase 19)
# int8 storage may cost the bench world's tracking cosine at most this
# much against float32's (phase 11): on the card the cosine of one world
# moves by up to 0.04 between runs that differ only in rounding (the
# batched and the plain step, bf16 against float32 activations; PERF.md
# §6), so bench.py's absolute 0.93 is printed for int8, not gated
QUANT_TRACKING_BAND = 0.05
BATCHES = (1, 8, 32)     # episodes per batch (phase 20)
BATCH_TIMED = 2_000      # timed batched steps (a multiple of BATCH_SEG)
BATCH_SEG = 2_000        # batched segment length: warm-up, then timed
BATCH_REPLAY = 1_000     # batched replay vs eager steps
BATCH_EPISODE_STEPS = 2_000   # each episode against a plain Simulator run
BATCH_EPISODE_FULL = 300      # ... the whole spike-flip bounds over these
BATCH_CHECKED = 8        # the batch whose episodes are checked
KERNEL_GROWTH = 1.2      # kernels per batched step <= 1.2 x B = 1's
# tests/torch_parity.py's spike-flip bounds (the tests import JAX, so the
# script carries its own copy): per-step max-abs over the probe, relative
# to max(|reference|, 1): median < atol, q80 < 5 atol, peak < 0.25, under
# 10 % of steps above 5 atol, the longest such run at most max(5, 3 %)
SPIKE_ATOL = 1e-3
# scaled_slam (bench.py:428-469): the view radius bounds the median error
SCALED_GATE = 0.4


def param_bytes(params):
    """Bytes of a parameter tree's tensors (a QTensor's payload and
    scales), and the bytes of the 1-byte payloads among them."""
    from sspslam_tpu_torch.nef.simulator import _flatten
    leaves = _flatten(params)
    total = sum(x.numel() * x.element_size() for x in leaves)
    one_byte = sum(x.numel() for x in leaves if x.element_size() == 1)
    return total, one_byte


def spike_flip_stats(got, want):
    """Per-step max-abs of ``got`` vs ``want`` (steps, ...) relative to
    max(|want|, 1): its median, q80 and peak, the share of steps above
    5 SPIKE_ATOL, the longest run of such steps, and the first step that
    differs at all."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shapes {got.shape} and {want.shape}")
    per_t = np.max(np.abs(got - want).reshape(len(got), -1), axis=1)
    per_t = per_t / max(float(np.max(np.abs(want))), 1.0)
    exc = per_t > 5 * SPIKE_ATOL
    run = longest = 0
    for e in exc:
        run = run + 1 if e else 0
        longest = max(longest, run)
    nonzero = np.flatnonzero(per_t > 0)
    return {"median": float(np.median(per_t)),
            "q80": float(np.quantile(per_t, 0.8)), "peak": float(per_t.max()),
            "above_5_atol": float(np.mean(exc)), "longest_run": longest,
            "first_differing_step": int(nonzero[0]) if nonzero.size else None,
            "steps": len(per_t)}


def spike_flip_check(got, want, what, whole=True):
    """``got`` vs ``want`` within the spike-flip bounds (``whole=False``:
    the q80 and peak bounds only); returns spike_flip_stats."""
    st = spike_flip_stats(got, want)
    ok = st["q80"] < 5 * SPIKE_ATOL and st["peak"] < 0.25
    if whole:
        ok = ok and (st["median"] < SPIKE_ATOL and st["above_5_atol"] < 0.10
                     and st["longest_run"] <= max(5, int(0.03 * st["steps"])))
    if not ok:
        raise AssertionError(f"{what}: outside the spike-flip bounds: {st}")
    return st


def quantised_slam(space, vco, f32):
    """Phase 19: SLAMNetwork at phase 11's width and traffic with int8 and
    fp8 parameter storage: graph replay against eager (<= 1e-6), kernels
    per replayed step, the tracking cosine over the world (int8 at most
    QUANT_TRACKING_BAND below float32's, and printed against bench.py's
    0.93; fp8 printed), steps/s over QUANT_TIMED steps and the bytes of
    the parameter tree, each beside phase 11's float32 numbers (``f32``);
    the VCO kernel launches 0 times."""
    from sspslam_tpu_torch.experiments.common import slam_world, slam_simulator
    world = slam_world()
    reset_vco_launches()
    out = {}
    for kind in ("int8", "fp8"):
        what = f"SLAM {kind}"
        sim, probe, build_s = slam_simulator(space, world,
                                             matmul_dtype=kind)
        total, one_byte = param_bytes(sim.params)
        r = {"build_s": build_s, "param_bytes": total,
             "param_bytes_one_byte_payloads": one_byte}
        log(f"{what} build: {build_s:.1f} s; parameter tree {total:,} bytes "
            f"({one_byte:,} in 1-byte payloads) against float32's "
            f"{f32['param_bytes']:,}")
        r["graph_vs_eager_max_abs"], r["steps_per_s_eager"] = \
            replay_vs_eager(sim, probe, what)
        k_graph, _, busy, share, top = profile_steps(sim, False)
        log(f"{what}: graph replay {k_graph:.2f} kernels per step (float32 "
            f"{f32['kernels_per_step_graph']:.2f}), busy {busy:.1f} us per "
            f"step = {share * 100:.1f} %")
        for name, us, calls in top:
            log(f"  {what} graph replay, per step: {us:6.2f} us in "
                f"{calls:.2f} x {name}")
        r.update(kernels_per_step_graph=k_graph,
                 device_busy_us_per_step_graph=busy, top_kernels_graph=top)
        sim.reset()
        sim.run_steps(WORLD_STEPS)
        trace = sim.data[probe]
        cos = tracking_cosine(space, trace, world[0])
        floor = f32["tracking_cosine"] - QUANT_TRACKING_BAND
        gated = kind == "int8"
        log(f"{what} tracking cosine (last quarter of the {WORLD_STEPS}-step "
            f"world): {cos:.4f} (float32 {f32['tracking_cosine']:.4f}; "
            f"bench.py's {TRACKING_GATE}: "
            f"{'met' if cos >= TRACKING_GATE else 'not met'}; "
            + (f"gate >= float32 - {QUANT_TRACKING_BAND} = {floor:.4f})"
               if gated else "printed)"))
        if not (np.all(np.isfinite(trace)) and np.isfinite(cos)
                and (cos >= floor or not gated)):
            raise AssertionError(f"{what}: tracking cosine {cos} < {floor}")
        r["tracking_cosine"] = cos
        rate, timed, window = timed_run(sim, probe, QUANT_TIMED, SIM_WARM)
        log(f"{what}: {rate:.0f} steps/s over {QUANT_TIMED} steps (float32 "
            f"{f32['steps_per_s']:.0f}); window ({ClockSampler.QUERY}): "
            f"just before {window[0]}; just after {window[1]}")
        if not np.all(np.isfinite(timed)):
            raise AssertionError(f"{what}: the timed run is not finite")
        r["steps_per_s"] = rate
        r["timed_window_nvidia_smi"] = window
        out[kind] = r
        del sim
    out["vco_scan_launches"] = vco_launches()
    if out["vco_scan_launches"] != 0:
        raise AssertionError("the quantised SLAM paths launched vco_scan")
    return out


def episode_tables(sim, space, B):
    """(T, B, size) input tables, in ``sim.model.input_nodes`` order, of B
    episodes of bench.py --model slam's world: the same path, and episode
    b's SLAM_LANDMARKS landmarks drawn from seed SEED + b (episode 0 is
    the bench world)."""
    from sspslam_tpu_torch.experiments.common import slam_world, slam_inputs
    from sspslam_tpu_torch import SPSpace
    lm_space = SPSpace(SLAM_LANDMARKS, space.ssp_dim, seed=SEED)
    path, vels, _, _ = slam_world()
    nodes = sim.model.input_nodes
    built = [n.output for n in nodes]
    if len(nodes) != 5:
        raise AssertionError(f"{len(nodes)} tabulated inputs, not 5")
    per = []
    for b in range(B):
        lms = np.random.default_rng(SEED + b).uniform(
            -0.7, 0.7, size=(SLAM_LANDMARKS, 2))
        fns, _ = slam_inputs(space, lm_space,
                             (path, vels, lms, lms[None] - path[:, None]))
        # the nodes are created in slam_inputs' order, and are the
        # model's only tabulated inputs
        for n, f in zip(nodes, fns):
            n.output = f
        try:
            per.append(sim._tabulate_inputs(WORLD_STEPS))
        finally:
            for n, f in zip(nodes, built):
                n.output = f
    return [torch.as_tensor(np.stack([p[i] for p in per], axis=1),
                            dtype=torch.float32) for i in range(len(nodes))]


def batched_profile(runner):
    """Kernels and device busy us per replayed batched step over
    PROFILE_STEPS steps (one profiler pass, graphs already captured)."""
    from sspslam_tpu_torch.experiments.device_time_probe import \
        profile_steps as profiled

    def run():
        runner.run(PROFILE_STEPS)
        runner.sync()
    run()
    p = profiled(run, PROFILE_STEPS)
    return p["kernels_per_step"], p["busy_us_per_step"]


def batched_episodes(space, vco):
    """Phase 20: B = 1, 8 and 32 episodes of phase 11's float32 SLAM
    through parallel.BatchedEpisodes (the step under torch.func.vmap,
    graphs of GRAPH_STEPS batched steps): aggregate steps/s over
    BATCH_TIMED steps after one BATCH_SEG-step warm-up segment, kernels per
    replayed batched step (<= KERNEL_GROWTH x B = 1's: the batch did not
    loop), the peak device memory; at B = BATCH_CHECKED the batched replay
    against its eager step (<= 1e-6) and every episode against a plain
    Simulator run of the same episode: the whole spike-flip bounds over the
    first BATCH_EPISODE_FULL steps, their q80 and peak over
    BATCH_EPISODE_STEPS, and the median printed beside the same statistic
    between two batched runs of one episode (B = 1 and B = BATCH_CHECKED),
    which differ only in the shape of their matrix products."""
    from sspslam_tpu_torch.experiments.common import slam_world, slam_simulator
    from sspslam_tpu_torch.parallel import BatchedEpisodes
    reset_vco_launches()
    sim, probe, build_s = slam_simulator(space, slam_world())
    pi = next(bp.index for bp in sim.model.probes if bp.obj is probe)
    log(f"SLAM for batched episodes: build {build_s:.1f} s")
    tables = episode_tables(sim, space, max(BATCHES))
    out = {"build_s": build_s}
    for B in BATCHES:
        torch.cuda.reset_peak_memory_stats()
        runner = BatchedEpisodes(sim, [t[:, :B] for t in tables])
        t0 = time.perf_counter()
        runner.run(BATCH_SEG)
        runner.sync()
        warm = time.perf_counter() - t0
        before = nvidia_smi(ClockSampler.QUERY)
        t0 = time.perf_counter()
        for _ in range(BATCH_TIMED // BATCH_SEG):
            bufs = runner.run(BATCH_SEG)
        runner.sync()
        rate = B * BATCH_TIMED / (time.perf_counter() - t0)
        after = nvidia_smi(ClockSampler.QUERY)
        if not torch.isfinite(bufs[pi]).all():
            raise AssertionError(f"B = {B}: the batched run is not finite")
        kernels, busy = batched_profile(runner)
        peak = torch.cuda.max_memory_allocated()
        out[str(B)] = {"agg_steps_per_s": rate, "kernels_per_step": kernels,
                       "device_busy_us_per_step": busy,
                       "max_memory_allocated": peak, "warm_up_s": warm,
                       "timed_window_nvidia_smi": [before, after]}
        log(f"batched SLAM, B = {B}: {rate:.0f} aggregate steps/s over "
            f"{BATCH_TIMED} steps ({rate / B:.0f} a episode; warm-up segment "
            f"with capture {warm:.1f} s); {kernels:.2f} kernels, busy "
            f"{busy:.1f} us per replayed batched step; peak memory "
            f"{peak / 2**20:.0f} MiB; window: just before {before}; just "
            f"after {after}")
        del runner, bufs
    k1 = out["1"]["kernels_per_step"]
    for B in BATCHES[1:]:
        if not out[str(B)]["kernels_per_step"] <= KERNEL_GROWTH * k1:
            raise AssertionError(
                f"B = {B}: {out[str(B)]['kernels_per_step']} kernels per "
                f"batched step against B = 1's {k1}: the batch loops")

    def batched(B, steps, eager=False):
        runner = BatchedEpisodes(sim, [t[:, :B] for t in tables])
        runner.loop.eager = eager
        return runner.run(steps)[pi].cpu().numpy()

    # replay vs eager of the batched step
    B = BATCH_CHECKED
    got = {}
    lif = {"replay": lif_calls(
               lambda: got.setdefault("replay", batched(B, BATCH_REPLAY))),
           "eager": lif_calls(lambda: got.setdefault(
               "eager", batched(B, BATCH_REPLAY, eager=True)))}
    replay = got["replay"]
    err = float(np.abs(replay - got["eager"]).max())
    # the step under torch.func.vmap keeps the chain (the kernel has no
    # batching rule)
    log(f"batched SLAM, B = {B}: LIF.step calls (kernel, chain) {lif}")
    if not all(f == 0 and p > 0 for f, p in lif.values()):
        raise AssertionError(f"batched SLAM: LIF paths {lif}")
    out["lif_calls"] = lif
    log(f"batched SLAM, B = {B}: graph replay vs eager, {BATCH_REPLAY} "
        f"steps: max-abs {err:.3e} (tol {REPLAY_TOL})")
    if not (np.all(np.isfinite(replay)) and err <= REPLAY_TOL):
        raise AssertionError(f"batched replay differs from eager: {err}")
    out["graph_vs_eager_max_abs"] = err

    # each episode against a plain Simulator run of the same episode
    trace = batched(B, BATCH_EPISODE_STEPS)
    control = spike_flip_stats(trace[:, 0],
                               batched(1, BATCH_EPISODE_STEPS)[:, 0])
    log(f"batched SLAM, episode 0 at B = 1 vs at B = {B} over "
        f"{BATCH_EPISODE_STEPS} steps: {control}")
    out["episode_0_b1_vs_b8"] = control
    flips = []
    for b in range(B):
        sim.reset()
        sim._preloaded = np.concatenate(
            [t[:, b].numpy() for t in tables], axis=1)
        sim._preloaded_dev = torch.as_tensor(sim._preloaded).to(sim.device)
        sim._preload_start = 0
        sim.run_steps(BATCH_EPISODE_STEPS, segment_steps=BATCH_EPISODE_STEPS)
        plain = sim.data[probe]
        n = BATCH_EPISODE_FULL
        spike_flip_check(trace[:n, b], plain[:n],
                         f"batched episode {b}, first {n} steps")
        flips.append(spike_flip_check(trace[:, b], plain,
                                      f"batched episode {b}", whole=False))
        log(f"batched SLAM, B = {B}, episode {b} vs its plain run: within the "
            f"spike-flip bounds over the first {n} steps; over "
            f"{BATCH_EPISODE_STEPS}: {flips[-1]}")
    out["episodes_vs_plain"] = flips
    del sim
    out["vco_scan_launches"] = vco_launches()
    if out["vco_scan_launches"] != 0:
        raise AssertionError("the batched episodes launched vco_scan")
    return out


SCALED_ARGS = ("--T", "40", "--seeds", "0,1", "--param-dtype", "int8",
               "--no-pi-control", "--table-cache", "")
# the --dp-sweep rows are throughput only: a 4 s world (T x limit >= 1)
SWEEP_ARGS = ("--T", "4", "--limit", "0.3", "--seeds", "0",
              "--no-pi-control", "--table-cache", "", "--dp-sweep", "1,2,8")


def last_json(stdout):
    """The last line of a CLI's output that is its result object."""
    return json.loads(next(line for line in reversed(stdout.splitlines())
                           if line.startswith('{"metric"')))


def scaled_slam(work):
    """Phase 21: the reference's second bar, ``scaled_slam --T 40 --seeds
    0,1 --param-dtype int8 --no-pi-control`` (ssp_dim 201 in 3-D, 101
    VCOs x 800 LIF, memory 10,000, 100 landmarks, 2 batched episodes), as
    a counted child: exit 0, median_err_slam <= SCALED_GATE, its npz
    saved into ``work`` (phase 30 re-decodes it); then its --dp-sweep
    1,2,8 at T = 4 (one row per B)."""
    stdout, seconds, launches = run_counted(
        "scaled_slam", *SCALED_ARGS, "--save", "--save-dir", work,
        timeout=900)
    res = last_json(stdout)
    med = res["median_err_slam"]
    log(f"scaled_slam int8: exit 0 in {seconds:.1f} s; median_err_slam "
        f"{med} (gate <= {SCALED_GATE}); {res['agg_steps_per_s']} aggregate "
        f"steps/s; build {res['build_s']} s; peak memory "
        f"{res['max_memory_allocated'] / 2**20:.0f} MiB")
    if not (np.isfinite(med) and med <= SCALED_GATE):
        raise AssertionError(f"scaled_slam median_err_slam {med} > "
                             f"{SCALED_GATE}")
    out = {"median_err_slam": med, "per_seed": res["per_seed"],
           "agg_steps_per_s": res["agg_steps_per_s"], "mfu": res["mfu"],
           "build_s": res["build_s"],
           "max_memory_allocated": res["max_memory_allocated"],
           "seconds": seconds, "vco_scan_launches": launches}
    stdout, seconds, launches = run_counted("scaled_slam", *SWEEP_ARGS,
                                            timeout=900)
    rows = last_json(stdout)["dp_sweep"]
    if [r["B"] for r in rows] != [1, 2, 8] or not all(
            r["agg_steps_per_s"] > 0 for r in rows):
        raise AssertionError(f"scaled_slam --dp-sweep printed {rows}")
    log(f"scaled_slam --dp-sweep 1,2,8: exit 0 in {seconds:.1f} s; "
        + "; ".join(f"B = {r['B']}: {r['agg_steps_per_s']} aggregate steps/s"
                    for r in rows))
    out["dp_sweep"] = rows
    out["dp_sweep_seconds"] = seconds
    out["dp_sweep_vco_scan_launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phases 22-24: training through episodes and closed-loop sessions
# ---------------------------------------------------------------------------

TRAIN_STEPS = 600        # train_pathint's --T-steps
TRAIN_SEG = 100          # its --segment-steps
REMAT_TOL = 1e-5         # remat vs plain gradient, relative to max |g|
CARD_CPU_TOL = 1e-4      # card vs CPU gradients (TF32 off), relative
# the recurrent decoders' gradient is held card vs CPU where backprop
# through the dynamics is stable: RectifiedLinear neurons (LIFRate's slope
# is unbounded at threshold) over one TRAIN_SEG-step segment; a one-rounding
# nudge of the decoders must move it by at most CARD_CPU_TOL / NUDGE_MARGIN
NUDGE = 2.0 ** -22
NUDGE_MARGIN = 10
SURROGATE_STEPS = 300
SURROGATE_RTOL = 1e-5    # SurrogateLIF vs LIF forward traces
TRAIN_PROFILE_STEPS = 20  # forward steps profiled under autograd
# at 800 per VCO the CLI's default --lr 2e-4 raises the loss in the JAX
# package's train_pathint as in the port's; 1e-7 lowers it in both (PERF.md)
TRAIN_ARGS = ("--ssp-dim", str(SSP_DIM), "--pi-n-neurons", str(N_NEURONS),
              "--T-steps", str(TRAIN_STEPS), "--segment-steps",
              str(TRAIN_SEG), "--fit-steps", "5", "--lr", "1e-7")
# train_slam at the flagship width; depth (T = 0.6 s, 2 meta-steps) is
# the only cut
SLAM_TRAIN_ARGS = ("--T", "0.6", "--ssp-dim", str(SSP_DIM), "--pi-n-neurons",
                   str(N_NEURONS), "--mem-n-neurons", "970",
                   "--cc-n-neurons", "100", "--fit-steps", "2",
                   "--segment-steps", "200")
# train_slam's first meta-gradient, card against CPU, at a tiny width and
# a depth at which the gate has corrected (at the flagship width it has
# not by T = 2 s, so the gradient there is exactly 0: PERF.md), the
# clean-up's argmax in float32 on both sides
META_ARGS = ("--T", "0.5", "--ssp-dim", "13", "--pi-n-neurons", "30",
             "--mem-n-neurons", "40", "--cc-n-neurons", "10",
             "--n-landmarks", "4", "--fit-steps", "1", "--segment-steps",
             "100")
META_ENV = {"SSPSLAM_CLEANUP_F32": "1"}
# relative to the largest component: LIFRate's unbounded slope at threshold
# grows the devices' different roundings over the episode (the JAX and
# port CPU gradients differ by 9e-4, tests/test_torch_train.py)
META_GRAD_TOL = 5e-3
# the sweep at its default (flagship) widths, trimmed grids, short worlds
TUNE_ARGS = ("--quick", "--T", "1", "--final-T", "1", "--top", "1")
# tune_loop_closure's in-place configuration against a fresh build: its
# world (the CLI's defaults) over this many seconds
TUNE_CHECK_T = 1.0
TICK = 50                # closed_loop_nav's --tick-steps
LOOP_STEPS = 2_000       # ticks held to one uninterrupted run
LATENCY_TICKS = 100      # ticks timed after the check


def pathint_training_sim(device, neuron_type=None):
    """train_pathint's model and training world at full width (ssp_dim
    97, 49 VCOs x 800 neurons, LIFRate unless ``neuron_type``) on
    ``device``: (simulator, probe, PathIntegration, encoded path)."""
    from sspslam_tpu_torch import HexagonalSSPSpace
    from sspslam_tpu_torch.experiments.train_pathint import make_world
    from sspslam_tpu_torch.models import PathIntegration
    from sspslam_tpu_torch.nef import (Connection, LIFRate, Network, Node,
                                       Probe, Simulator, TimeTable,
                                       clamp_table)
    dt = 0.001
    space = HexagonalSSPSpace(2, ssp_dim=SSP_DIM, seed=SEED, length_scale=0.3,
                              domain_bounds=1.2 * np.tile([-1, 1.0], (2, 1)))
    path, vels = make_world(1, TRAIN_STEPS, dt)
    _, vels_te = make_world(7, TRAIN_STEPS, dt)
    scale = 1 / max(np.max(np.abs(space.phase_matrix @ vels.T)),
                    np.max(np.abs(space.phase_matrix @ vels_te.T)))
    with Network(seed=SEED) as net:
        vel = Node(TimeTable((vels * scale).astype(np.float32), dt))
        init = Node(clamp_table(space.encode(path[:1]).flatten(), 0.05, dt))
        pi = PathIntegration(space, N_NEURONS, 0.05, scaling_factor=scale,
                             neuron_type=neuron_type or LIFRate())
        Connection(vel, pi.velocity_input, synapse=None)
        Connection(init, pi.input, synapse=None)
        probe = Probe(pi.output, synapse=0.02)
    sim = Simulator(net, seed=SEED, device=device)
    return sim, probe, pi, space.encode(path).astype(np.float32)


def episode_gradient(sim, probe, targ, params, path, remat,
                     n_steps=TRAIN_STEPS):
    """train_pathint's loss over one ``n_steps`` episode (its mask: the
    first min(100, n_steps // 4) steps settle) and its gradient with
    respect to the leaf at ``path``, on ``sim.device``: (gradient as
    NumPy, loss, peak device bytes above the start, seconds)."""
    from sspslam_tpu_torch import train
    dev = sim.device
    ep = train.make_episode_fn(sim, n_steps,
                               segment_steps=min(TRAIN_SEG, n_steps),
                               remat=remat)
    xs = train.episode_inputs(sim, n_steps)
    pidx = train.probe_index(sim, probe)
    mask = torch.as_tensor((np.arange(n_steps) >= min(100, n_steps // 4))
                           .astype(np.float32)[:, None], device=dev)
    targ = torch.as_tensor(targ[:n_steps], device=dev)
    trainable, frozen = train.partition_params(params, lambda s: s == path)
    leaf = []

    def grad_leaf(x):
        if x is None:
            return None
        leaf.append(x.detach().clone().requires_grad_(True))
        return leaf[-1]
    trainable = train._tree_map(grad_leaf, trainable)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    _, emits = ep(train.merge_params(trainable, frozen), xs,
                  sim.model.initial_state())
    loss = torch.sum(mask * (emits[pidx] - targ) ** 2) / torch.sum(mask)
    g, = torch.autograd.grad(loss, leaf[0])
    g = g.cpu().numpy()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    return g, float(loss.detach()), peak, seconds


def autograd_kernels(sim, probe, params, path):
    """CUDA kernels per step of TRAIN_PROFILE_STEPS steps of an episode
    under autograd (one torch.profiler pass after a warm-up): the forward
    pass alone, then forward and backward together."""
    from sspslam_tpu_torch import train
    from sspslam_tpu_torch.experiments.device_time_probe import \
        profile_steps as profiled
    n = TRAIN_PROFILE_STEPS
    ep = train.make_episode_fn(sim, n, segment_steps=n, remat=False)
    xs = train.episode_inputs(sim, n)
    pidx = train.probe_index(sim, probe)
    trainable, frozen = train.partition_params(params, lambda s: s == path)
    trainable = train._tree_map(
        lambda x: None if x is None else
        x.detach().clone().requires_grad_(True), trainable)
    full = train.merge_params(trainable, frozen)
    leaf = next(x for _, x in train._leaves_with_paths(trainable)
                if x is not None)

    def run(backward):
        _, emits = ep(full, xs, sim.model.initial_state())
        if backward:
            torch.autograd.grad(emits[pidx].square().sum(), leaf)
        torch.cuda.synchronize()

    counts = []
    for backward in (False, True):
        run(backward)
        counts.append(profiled(lambda: run(backward), n)["kernels_per_step"])
    return counts


def rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def nudged(params, path, eps=NUDGE):
    """``params`` with the connection leaf at ``path`` ("conn/<i>/D")
    scaled by 1 + eps (the other leaves shared)."""
    from sspslam_tpu_torch.train import _tree_map
    out = _tree_map(lambda x: x, params)
    _, key, leaf = path.split("/")
    out["conn"][key] = dict(out["conn"][key],
                            **{leaf: params["conn"][key][leaf] * (1 + eps)})
    return out


def cli_line(stdout, prefix):
    return next(line for line in stdout.splitlines()
                if line.startswith(prefix))


def cli_numbers(line):
    import re
    return [float(x) for x in
            re.findall(r"-?\d+\.\d+(?:e-?\d+)?", line.split(":", 1)[1])]


def train_pathint_phase(vco):
    """Phase 22: training at the PI fast path's full width (ssp_dim 97, 49
    VCOs x 800 LIFRate, train_pathint's worlds): (a) the gradient of the
    loss with respect to the recurrent decoders, checkpointed segments
    against the plain loop (within REMAT_TOL relative; the peak memory of
    each, remat's lower), and the kernels per step under autograd beside
    the replayed step's; (b) the card's readout-decoder gradient against
    the CPU's on the same params (TF32 off; within CARD_CPU_TOL relative),
    the recurrent decoders' difference (printed: LIFRate's unbounded slope
    at threshold makes it move under a one-rounding nudge), and the
    recurrent decoders' gradient of a TRAIN_SEG-step episode of the same
    model with RectifiedLinear neurons, card against CPU (within
    CARD_CPU_TOL), with the nudge moving it by at most CARD_CPU_TOL /
    NUDGE_MARGIN; (c)
    SurrogateLIF's forward against LIF's over SURROGATE_STEPS steps
    (within SURROGATE_RTOL); (d) ``train_pathint`` as a counted child with
    5 fit steps: its loss falls."""
    from sspslam_tpu_torch import train
    from sspslam_tpu_torch.nef import LIF, RectifiedLinear, SurrogateLIF
    from sspslam_tpu_torch.train import _tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_vco_launches()
    out = {}
    t0 = time.perf_counter()
    sim, probe, pi, targ = pathint_training_sim("cuda")
    out["build_s"] = time.perf_counter() - t0
    path = train.connection_param_path(sim, pi.recurrent)
    runs = {}
    for remat in (False, True):
        episode_gradient(sim, probe, targ, sim.params, path, remat)  # warm
        runs[remat] = episode_gradient(sim, probe, targ, sim.params, path,
                                       remat)
    g_plain, loss, peak_plain, s_plain = runs[False]
    g_remat, _, peak_remat, s_remat = runs[True]
    err = rel_err(g_remat, g_plain)
    log(f"train (PI, {TRAIN_STEPS} steps, {path}): loss {loss:.6f}; remat "
        f"vs plain gradient: {err:.3e} relative (tol {REMAT_TOL}); peak "
        f"memory remat {peak_remat / 2**20:.1f} MiB, plain "
        f"{peak_plain / 2**20:.1f} MiB; loss + gradient {s_remat:.2f} s "
        f"remat, {s_plain:.2f} s plain")
    if not (np.all(np.isfinite(g_remat)) and np.abs(g_plain).max() > 0
            and err <= REMAT_TOL and peak_remat < peak_plain):
        raise AssertionError(f"remat gradient {err}, peak {peak_remat} vs "
                             f"{peak_plain}")
    k_fwd, k_both = autograd_kernels(sim, probe, sim.params, path)
    k_graph = profile_steps(sim, False)[0]
    sim.reset()   # episode_inputs tabulates from the simulator's step
    log(f"train: kernels per step under autograd: forward {k_fwd:.2f}, "
        f"forward + backward {k_both:.2f}; the replayed step "
        f"{k_graph:.2f}")
    out.update(loss=loss, remat_vs_plain_rel=err,
               peak_bytes_remat=peak_remat, peak_bytes_plain=peak_plain,
               seconds_remat=s_remat, seconds_plain=s_plain,
               kernels_per_step_forward_autograd=k_fwd,
               kernels_per_step_forward_backward=k_both,
               kernels_per_step_replayed=k_graph)

    # (b) the same episode on the CPU, on the card's params: the readout
    # decoders' gradient (no backprop through the dynamics) is held; the
    # recurrent decoders' is printed beside its change when the forward
    # pass moves by one rounding (LIFRate's slope is unbounded at the
    # threshold, so backprop through 600 recurrent steps amplifies the
    # last bit of a current)
    readout = next(f"conn/{bc.index}/D" for bc in sim.model.connections
                   if bc.decoders is not None and bc.post_kind == "node")
    cpu_sim, cpu_probe, _, _ = pathint_training_sim("cpu")
    cpu_params = _tree_map(lambda x: x.cpu(), sim.params)
    g_out, loss_out, _, _ = episode_gradient(sim, probe, targ, sim.params,
                                             readout, True)
    g_out_cpu, loss_cpu, _, s_cpu = episode_gradient(
        cpu_sim, cpu_probe, targ, cpu_params, readout, True)
    g_rec_cpu = episode_gradient(cpu_sim, cpu_probe, targ, cpu_params, path,
                                 True)[0]
    g_rec_nudged = episode_gradient(sim, probe, targ, nudged(sim.params, path),
                                    path, True)[0]
    err = rel_err(g_out, g_out_cpu)
    rec_cpu, rec_nudged = (rel_err(g_remat, g_rec_cpu),
                           rel_err(g_rec_nudged, g_remat))
    log(f"train: card vs CPU (TF32 off), loss {loss_out:.7f} vs "
        f"{loss_cpu:.7f}: the readout decoders' ({readout}) gradient "
        f"{err:.3e} relative (tol {CARD_CPU_TOL}); the recurrent decoders' "
        f"{rec_cpu:.3e}, and on the card with them scaled by 1 + 2^-22 "
        f"{rec_nudged:.3e} (printed); CPU {s_cpu:.1f} s a gradient")
    if not (np.abs(g_out).max() > 0 and err <= CARD_CPU_TOL):
        raise AssertionError(f"card vs CPU gradient {err}")
    out.update(card_vs_cpu_readout_rel=err, card_vs_cpu_recurrent_rel=rec_cpu,
               recurrent_vs_nudged_rel=rec_nudged, cpu_seconds=s_cpu)
    del cpu_sim, sim

    # backprop through the recurrent dynamics, card against CPU, where the
    # gradient is stable: RectifiedLinear, one segment
    relu, relu_cpu = (pathint_training_sim(dev, RectifiedLinear())
                      for dev in ("cuda", "cpu"))
    sim, probe, pi, targ = relu
    rpath = train.connection_param_path(sim, pi.recurrent)
    g_relu, loss_relu, _, _ = episode_gradient(sim, probe, targ, sim.params,
                                               rpath, True, TRAIN_SEG)
    g_relu_cpu, loss_relu_cpu, _, _ = episode_gradient(
        relu_cpu[0], relu_cpu[1], targ, _tree_map(lambda x: x.cpu(),
                                                  sim.params),
        rpath, True, TRAIN_SEG)
    g_relu_nudged = episode_gradient(sim, probe, targ,
                                     nudged(sim.params, rpath), rpath, True,
                                     TRAIN_SEG)[0]
    rec_err, rec_nudge = (rel_err(g_relu, g_relu_cpu),
                          rel_err(g_relu_nudged, g_relu))
    log(f"train: RectifiedLinear, {TRAIN_SEG} steps, card vs CPU (TF32 off), "
        f"loss {loss_relu:.7f} vs {loss_relu_cpu:.7f}: the recurrent "
        f"decoders' ({rpath}) gradient {rec_err:.3e} relative (tol "
        f"{CARD_CPU_TOL}); on the card with them scaled by 1 + 2^-22 "
        f"{rec_nudge:.3e} (tol {CARD_CPU_TOL / NUDGE_MARGIN})")
    if not (np.all(np.isfinite(g_relu)) and np.abs(g_relu).max() > 0
            and rec_err <= CARD_CPU_TOL
            and rec_nudge <= CARD_CPU_TOL / NUDGE_MARGIN):
        raise AssertionError(f"recurrent gradient card vs CPU {rec_err}, "
                             f"under the nudge {rec_nudge}")
    out.update(relu_card_vs_cpu_recurrent_rel=rec_err,
               relu_recurrent_vs_nudged_rel=rec_nudge)
    del relu, relu_cpu, sim

    # (c) SurrogateLIF's forward pass is LIF's
    traces = []
    for nt in (LIF(), SurrogateLIF()):
        s, p, _, _ = pathint_training_sim("cuda", nt)
        s.run_steps(SURROGATE_STEPS)
        traces.append(s.data[p])
        del s
    diff = float(np.abs(traces[1] - traces[0]).max())
    log(f"train: SurrogateLIF vs LIF forward, {SURROGATE_STEPS} steps: "
        f"max-abs {diff:.3e} (rtol {SURROGATE_RTOL})")
    if not (np.all(np.isfinite(traces[0])) and np.allclose(
            traces[1], traces[0], rtol=SURROGATE_RTOL, atol=1e-7)):
        raise AssertionError(f"SurrogateLIF forward differs from LIF: {diff}")
    out["surrogate_vs_lif_max_abs"] = diff
    launches = vco_launches()
    if launches != 0:
        raise AssertionError(f"training launched vco_scan {launches} times")
    out["vco_scan_launches"] = launches

    # (d) the CLI
    stdout, seconds, launches = run_counted("train_pathint", *TRAIN_ARGS)
    before = cli_numbers(cli_line(stdout, "lstsq-solved:"))
    after = cli_numbers(cli_line(stdout, "backprop-tuned:"))
    fit = cli_line(stdout, "fit:")
    fit_s = float(fit.split(" in ")[1].split("s")[0])
    first, last = cli_numbers(fit)[-2:]
    n_fit = int(TRAIN_ARGS[TRAIN_ARGS.index("--fit-steps") + 1])
    log(f"train_pathint: exit 0 in {seconds:.1f} s; loss {first} -> {last}; "
        f"errors before {before}, after {after}; {fit_s / n_fit:.2f} s per "
        f"fit step")
    if not (np.isfinite(last) and last < first
            and np.all(np.isfinite(before + after))):
        raise AssertionError(f"train_pathint: loss {first} -> {last}")
    out["train_pathint"] = {
        "loss_first": first, "loss_last": last, "err_before": before,
        "err_after": after, "seconds_per_fit_step": fit_s / n_fit,
        "peak_mib": int(cli_line(stdout, "peak device memory:").split()[3]),
        "seconds": seconds, "vco_scan_launches": launches}
    return out


def train_slam_phase(vco, children):
    """Phase 23, from ``children`` (counted results run with phase 18's):
    ``train_slam`` at the flagship width (ssp_dim 97, 800 per VCO, memory
    970, 100 per circular-convolution dimension), depth cut
    (SLAM_TRAIN_ARGS): its losses and first meta-gradient finite, its
    tuned scalars finite and non-negative (its seconds per meta-step are
    printed, taken beside the other children); train_slam's first
    meta-gradient at META_ARGS on the card against the CPU's, nonzero and
    within META_GRAD_TOL; ``tune_loop_closure`` (TUNE_ARGS): 8 finite
    rows; and ``tune_in_place``."""
    import ast
    meta = {dev: ast.literal_eval(cli_line(
        children[f"train_slam_meta_{dev}"][0], "first meta-gradient:")
        .split(":", 1)[1].strip()) for dev in ("cuda", "cpu")}
    g_card, g_cpu = (np.array([meta[dev][k] for k in sorted(meta["cpu"])])
                     for dev in ("cuda", "cpu"))
    meta_err = rel_err(g_card, g_cpu)
    log(f"train_slam {' '.join(META_ARGS)}: first meta-gradient on the card "
        f"{meta['cuda']}, on the CPU {meta['cpu']}: {meta_err:.3e} relative "
        f"to the largest (tol {META_GRAD_TOL})")
    if not (meta["cuda"].keys() == meta["cpu"].keys()
            and np.all(np.isfinite(g_card)) and np.abs(g_cpu).max() > 0
            and meta_err <= META_GRAD_TOL):
        raise AssertionError(f"train_slam meta-gradient: card {meta['cuda']}"
                             f", CPU {meta['cpu']}")
    stdout, seconds, launches = children["train_slam"]
    tuned, grad = (ast.literal_eval(cli_line(stdout, p).split(":", 1)[1]
                                    .strip())
                   for p in ("tuned:", "first meta-gradient:"))
    fit = cli_line(stdout, "fit:")
    fit_s = float(fit.split(" in ")[1].split("s")[0])
    losses = cli_numbers(fit)[-2:]
    n_fit = int(SLAM_TRAIN_ARGS[SLAM_TRAIN_ARGS.index("--fit-steps") + 1])
    peak = int(cli_line(stdout, "peak device memory:").split()[3])
    errs = [cli_numbers(cli_line(stdout, p))
            for p in ("swept defaults", "gradient-tuned:")]
    log(f"train_slam: exit 0 in {seconds:.1f} s; loss {losses[0]} -> "
        f"{losses[1]}; first meta-gradient {grad}; tuned {tuned}; "
        f"{fit_s / n_fit:.1f} s per meta-step (beside the other children); "
        f"peak {peak} MiB; errors {errs}")
    if not (len(tuned) == 3 and all(np.isfinite(v) and v >= 0
                                    for v in tuned.values())
            and grad.keys() == tuned.keys()
            and np.all(np.isfinite(list(grad.values())))
            and np.all(np.isfinite(losses))):
        raise AssertionError(f"train_slam: losses {losses}, first "
                             f"meta-gradient {grad}, tuned {tuned}")
    out = {"train_slam": {
        "tuned": tuned, "first_meta_gradient": grad, "losses": losses,
        "seconds_per_meta_step": fit_s / n_fit, "peak_mib": peak,
        "err_before_after": errs, "seconds": seconds,
        "vco_scan_launches": launches},
        "meta_gradient_card_vs_cpu": {
            "card": meta["cuda"], "cpu": meta["cpu"], "rel": meta_err,
            "vco_scan_launches": children["train_slam_meta_cuda"][2]}}
    out["tune_in_place"] = tune_in_place(vco)
    stdout, seconds, launches = children["tune_loop_closure"]
    rows = [line for line in stdout.splitlines() if line.startswith("[s")]
    meds = [float(line.split("median ")[1].split(",")[0]) for line in rows]
    log(f"tune_loop_closure --quick: exit 0 in {seconds:.1f} s; "
        f"{len(rows)} configurations, medians {meds}")
    if len(rows) != 8 or not np.all(np.isfinite(meds)):
        raise AssertionError(f"tune_loop_closure printed {rows}")
    out["tune_loop_closure"] = {"medians": meds, "seconds": seconds,
                                "vco_scan_launches": launches}
    return out


def tune_in_place(vco):
    """Phase 23: tune_loop_closure's in-place configuration on the card,
    at its default (flagship) widths on its TUNE_CHECK_T-s world.  A
    simulator built with the sweep's base settings runs the world
    (capturing its graphs), is ``configure``d with other gate scalars and
    learning rates and runs it again through the same graphs; a simulator
    built with those settings runs it too.  The two runs' probe traces and
    final states agree within REPLAY_TOL and differ from the base run's."""
    from sspslam_tpu_torch import train
    from sspslam_tpu_torch.experiments import tune_loop_closure as tlc
    reset_vco_launches()
    world = tlc.make_world(TUNE_CHECK_T, 0)
    base = dict(update_thres=0.2, shift_rate=0.2, voja_lr=1e-4, pes_lr=5e-3,
                intercept=0.1)
    cfg = dict(base, update_thres=0.4, shift_rate=0.5, pes_lr=2e-2,
               voja_lr=5e-4)

    def run(sim, probe):
        tlc.run_config(sim, probe, world)
        return [sim.data[probe]] + [
            x.cpu().numpy() for _, x in train._leaves_with_paths(sim.state)]

    def max_abs(a, b):
        return max(float(np.abs(x.astype(np.float64) - y).max())
                   for x, y in zip(a, b))
    t0 = time.perf_counter()
    sim, probe = tlc.build_sim(world, base, 0, device="cuda")
    before = run(sim, probe)
    graphs = dict(sim.loop.graphs)
    tlc.configure(sim, cfg)
    got = run(sim, probe)
    same_graphs = (sim.loop.graphs.keys() == graphs.keys() and all(
        sim.loop.graphs[k] is g for k, g in graphs.items()))
    del sim
    fresh, fprobe = tlc.build_sim(world, cfg, 0, device="cuda")
    want = run(fresh, fprobe)
    del fresh
    err, moved = max_abs(got, want), max_abs(got, before)
    launches = vco_launches()
    log(f"tune_loop_closure, in place: base -> {cfg} written into a built "
        f"simulator's params, {world['n_steps']} steps: against a fresh "
        f"build max-abs {err:.3e} (tol {REPLAY_TOL}) over the probe trace "
        f"and the final state; moved from the base run by {moved:.3e}; the "
        f"same graphs replayed: {same_graphs} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (same_graphs and err <= REPLAY_TOL and moved > REPLAY_TOL
            and launches == 0):
        raise AssertionError(f"tune_loop_closure in place: {err} against a "
                             f"fresh build, moved {moved}, same graphs "
                             f"{same_graphs}, vco_scan launches {launches}")
    return {"vs_fresh_build_max_abs": err, "vs_base_max_abs": moved,
            "same_graphs": same_graphs, "vco_scan_launches": launches}


def closed_loop_phase(space, vco):
    """Phase 24: at phase 11's SLAM width on the bench world, a
    ClosedLoopSession of TICK-step ticks fed the world's rows against one
    uninterrupted run_steps of them over LOOP_STEPS steps (max-abs <=
    REPLAY_TOL), one capture for the tick length over all ticks, the tick
    latency over LATENCY_TICKS more; then ``closed_loop_nav`` at its
    defaults as a counted child."""
    from sspslam_tpu_torch.experiments.common import slam_world, slam_simulator
    from sspslam_tpu_torch.nef import ClosedLoopSession
    world = slam_world()
    reset_vco_launches()
    sim, probe, build_s = slam_simulator(space, world)
    sim.preload_inputs(LOOP_STEPS)
    sim.run_steps(LOOP_STEPS, segment_steps=LOOP_STEPS)
    want = sim.data[probe]
    sim.reset()
    rows = sim._pack_cols(sim._tabulate_inputs(LOOP_STEPS))
    nodes = list(zip(sim.model.input_nodes, sim.input_splits))
    sess = ClosedLoopSession(sim, outputs=[probe], tick_steps=TICK)
    t0 = time.perf_counter()
    sess.compile()
    sim.sync()
    compile_s = time.perf_counter() - t0
    graph = sim.loop.graphs[TICK]
    got = [sess.tick({n: rows[i:i + TICK, a:b] for n, (a, b) in nodes})[
        probe] for i in range(0, LOOP_STEPS, TICK)]
    got = np.concatenate(got)
    err = float(np.abs(got - want).max())
    lat = []
    hold = {n: rows[-1, a:b] for n, (a, b) in nodes}
    for _ in range(LATENCY_TICKS):
        t0 = time.perf_counter()
        sess.tick(hold)
        lat.append((time.perf_counter() - t0) * 1e3)
    one_capture = (list(sim.loop.graphs) == [TICK]
                   and sim.loop.graphs[TICK] is graph)
    med, p90, p99 = (float(np.percentile(lat, q)) for q in (50, 90, 99))
    log(f"closed loop (SLAM, ticks of {TICK}): ticks vs uninterrupted run, "
        f"{LOOP_STEPS} steps: max-abs {err:.3e} (tol {REPLAY_TOL}); graphs "
        f"after {LOOP_STEPS // TICK + LATENCY_TICKS} ticks: "
        f"{sorted(sim.loop.graphs)}, the first capture kept: {one_capture}; "
        f"capture {compile_s:.2f} s; tick latency over {LATENCY_TICKS} "
        f"ticks: median {med:.2f} ms, p90 {p90:.2f}, p99 {p99:.2f} "
        f"({1e3 / med:.1f} ticks/s, {TICK / med:.2f} x real time)")
    if not (got.shape == want.shape and np.all(np.isfinite(got))
            and err <= REPLAY_TOL and one_capture):
        raise AssertionError(f"closed loop: max-abs {err}, graphs "
                             f"{sorted(sim.loop.graphs)}")
    del sim, sess
    launches = vco_launches()
    if launches != 0:
        raise AssertionError(f"the closed loop launched vco_scan {launches} "
                             f"times")
    out = {"build_s": build_s, "ticks_vs_run_max_abs": err,
           "one_capture_per_tick_length": one_capture,
           "capture_s": compile_s, "tick_latency_ms_median": med,
           "tick_latency_ms_p90": p90, "tick_latency_ms_p99": p99,
           "vco_scan_launches": launches}
    stdout, seconds, launches = run_counted("closed_loop_nav")
    res = last_json(stdout)
    keys = ("reached_0p15", "final_dist", "min_dist",
            "explore_est_err_median", "nav_est_err_median",
            "tick_latency_ms_median", "tick_latency_ms_p90",
            "control_rate_hz", "realtime_factor", "n_ticks")
    log(f"closed_loop_nav: exit 0 in {seconds:.1f} s; "
        + json.dumps({k: res[k] for k in keys}))
    if not all(np.isfinite(res[k]) for k in keys[1:]):
        raise AssertionError(f"closed_loop_nav printed {res}")
    out["closed_loop_nav"] = dict({k: res[k] for k in keys},
                                  seconds=seconds,
                                  vco_scan_launches=launches)
    return out


SERVE_WARM = 2_000       # live steps before the export (phase 25)
SERVE_STEPS = 2_000      # steps served against the live run
SERVE_SEG = 1_000        # the bundle's segment length
SERVE_TIMED = 2_000      # timed steps, served and live
INTERP_STEPS = 300       # the interpreter against the card (phase 26)
TRACE_STEPS = 100        # replayed SLAM steps traced by trace_run (27)
SERVING_PROBE_ARGS = ("--timed-steps", "5000", "--segment-steps", "1000",
                      "--reps", "1")
NUMPY_SLAM_ARGS = ("--backend", "numpy", "--T", "0.3")

# A serving process: loads a bundle with the builder patched to raise,
# serves the rows, saves the probe rows and checks it imported no JAX.
_SERVE_CHILD = """
import sys
import numpy as np
import sspslam_tpu_torch.nef.builder as builder
import sspslam_tpu_torch.nef.simulator as simulator

def refuse(*a, **k):
    raise AssertionError("the serving process built a model")
builder.build = simulator.build = refuse
from sspslam_tpu_torch.nef import ServingModel
bundle, rows, out = sys.argv[1:4]
m = ServingModel(bundle, device="cuda")
(got,) = m.run(np.load(rows)).values()
np.save(out, got)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "sspslam_tpu", "ml_dtypes"))
if bad:
    raise AssertionError(f"the serving process imported {bad[:5]}")
print("served", got.shape)
"""


def _cpu_tree(tree):
    from sspslam_tpu_torch.ops.quantize import QTensor
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_tree(v) for v in tree]
    if isinstance(tree, QTensor):
        return tree.to("cpu")
    return tree.detach().cpu()


def cpu_twin(sim):
    """``sim`` as ``save_bundle`` reads it, on the CPU: the same model with
    the executor's step made for the CPU and the params and state copied
    there (a shallow copy, no second build)."""
    import copy
    from sspslam_tpu_torch.nef.executor import make_step_fn
    twin = copy.copy(sim)
    twin.device = torch.device("cpu")
    twin._step_fn = make_step_fn(sim.model, device="cpu")
    twin.loop = copy.copy(sim.loop)     # params of its own, sim's kept
    twin.loop.params = _cpu_tree(sim.params)
    twin.state = _cpu_tree(sim.state)
    return twin


def bundle_mb(path):
    return sum(f.stat().st_size for f in Path(path).iterdir()) / 1e6


def replay_kernels(graph, reset):
    """CUDA kernels by name per step of ``graph`` (GRAPH_STEPS captured
    steps), replayed PROFILE_STEPS / GRAPH_STEPS times under one profiler
    pass, ``reset()`` first (the graphs read their tables from row 0)."""
    from sspslam_tpu_torch.experiments.device_time_probe import \
        profile_steps as profiled
    from sspslam_tpu_torch.nef import Simulator
    reset()
    torch.cuda.synchronize()

    def run():
        for _ in range(PROFILE_STEPS // Simulator.GRAPH_STEPS):
            graph.replay()
        torch.cuda.synchronize()
    p = profiled(run, PROFILE_STEPS, top=None)
    return {name: calls for name, _, calls in p["top"]}


def serving_phase(space, vco, children, slam):
    """Phase 25: phase 11's SLAM warmed for SERVE_WARM steps and
    ``save_bundle``d (export seconds, MB); the bundle served by
    ``ServingModel`` on the card against the live Simulator's continued
    run of the same SERVE_STEPS rows (max-abs <= REPLAY_TOL); the same
    bundle served by a child process that builds nothing and imports no
    JAX (its rows equal this process's); a bundle exported on the CPU from
    the same model, served on the card; an int8 bundle against its live
    run; served and live steps/s over SERVE_TIMED steps; kernels per
    replayed served step; ``serving_probe``'s JSON (run with the untimed
    children)."""
    from sspslam_tpu_torch.experiments.common import (slam_simulator,
                                                      slam_world)
    from sspslam_tpu_torch.nef import ServingModel, save_bundle
    world = slam_world()
    reset_vco_launches()
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="serving_"))
    sim, probe, build_s = slam_simulator(space, world)
    out["build_s"] = build_s
    sim.preload_inputs(SERVE_WARM + SERVE_STEPS)
    live_lif = lif_calls(
        lambda: sim.run_steps(SERVE_WARM, segment_steps=SERVE_SEG))
    sim.sync()
    t0 = time.perf_counter()
    export_lif = lif_calls(
        lambda: save_bundle(sim, str(tmp / "card"), segment_steps=SERVE_SEG))
    out["export_s"] = time.perf_counter() - t0
    # the live Simulator's graphs capture the LIF kernel; save_bundle's one
    # real step before its trace takes it once a LIF group, and the trace
    # keeps the chain (the kernel has no tracing rule)
    out["lif_calls"] = {"live": live_lif, "export": export_lif}
    log(f"serving: LIF.step calls (kernel, chain) at the live capture "
        f"{live_lif}, in the export {export_lif}")
    if not (live_lif[0] > 0 and live_lif[1] == 0
            and export_lif[0] == len(LIF_GROUPS) and export_lif[1] > 0):
        raise AssertionError(f"serving: LIF paths {out['lif_calls']}")
    out["bundle_mb"] = bundle_mb(tmp / "card")
    # the rows the live run reads next (a node function of t tabulated
    # from another start rounds t otherwise)
    rows = sim._preloaded[SERVE_WARM:]
    np.save(tmp / "rows.npy", rows)
    child = subprocess.Popen(
        [sys.executable, "-c", _SERVE_CHILD, str(tmp / "card"),
         str(tmp / "rows.npy"), str(tmp / "child.npy")],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        save_bundle(cpu_twin(sim), str(tmp / "cpu"), segment_steps=SERVE_SEG)
        out["cpu_export_s"] = time.perf_counter() - t0
        sim.run_steps(SERVE_STEPS, segment_steps=SERVE_SEG)
        want = sim.data[probe][-SERVE_STEPS:]
        m = ServingModel(str(tmp / "card"), device="cuda")
        (got,) = m.run(rows).values()
        err = float(np.abs(got - want).max())
        (from_cpu,) = ServingModel(str(tmp / "cpu"), device="cuda").run(
            rows).values()
        cpu_err = float(np.abs(from_cpu - want).max())
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"serving child exited {child.returncode}: "
                             f"{stderr[-2000:]}")
    child_err = float(np.abs(np.load(tmp / "child.npy") - got).max())
    differ = np.flatnonzero(np.abs(got - want).reshape(len(got), -1).max(1))
    log(f"serving: export {out['export_s']:.1f} s (on the CPU "
        f"{out['cpu_export_s']:.1f} s), bundle {out['bundle_mb']:.1f} MB; "
        f"served vs live over {SERVE_STEPS} steps after {SERVE_WARM}: "
        f"max-abs {err:.3e} (tol {REPLAY_TOL}; first differing step "
        f"{differ[0] if differ.size else None}); child process (no build, no "
        f"JAX) vs this one: {child_err:.3e}; the CPU-exported bundle on the "
        f"card vs live: {cpu_err:.3e}")
    if not (np.all(np.isfinite(got)) and got.shape == want.shape
            and err <= REPLAY_TOL and child_err == 0.0
            and cpu_err <= REPLAY_TOL):
        raise AssertionError(f"serving: served vs live {err}, child "
                             f"{child_err}, CPU export {cpu_err}")
    out.update(served_vs_live_max_abs=err, child_vs_parent_max_abs=child_err,
               cpu_export_vs_live_max_abs=cpu_err)

    # steps/s, served (upload and final pull included) and live
    sim.preload_inputs(SERVE_SEG + SERVE_TIMED)
    rows = sim._preloaded[SERVE_SEG:]
    sim.run_steps(SERVE_SEG, segment_steps=SERVE_SEG)
    sim.sync()
    t0 = time.perf_counter()
    sim.run_steps(SERVE_TIMED, segment_steps=SERVE_SEG)
    sim.sync()
    live = SERVE_TIMED / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    timed = next(iter(m.run(rows).values()))
    served = SERVE_TIMED / (time.perf_counter() - t0)
    from sspslam_tpu_torch.nef import Simulator
    k_served = replay_kernels(m.loop.graph(Simulator.GRAPH_STEPS),
                              m.loop.start)
    k_live = replay_kernels(sim.loop.graph(Simulator.GRAPH_STEPS),
                            sim.loop.start)
    differ = {k: (k_served.get(k, 0), k_live.get(k, 0))
              for k in set(k_served) | set(k_live)
              if k_served.get(k, 0) != k_live.get(k, 0)}
    log(f"serving: {served:.0f} steps/s served (per-segment upload and the "
        f"final pull included) against {live:.0f} live, over {SERVE_TIMED} "
        f"steps; kernels per replayed step: served "
        f"{sum(k_served.values()):.2f}, live {sum(k_live.values()):.2f} "
        f"(phase 11: {slam['kernels_per_step_graph']:.2f}); differing "
        f"(served, live): "
        + "; ".join(f"{k[:70]}: {a:.2f}, {b:.2f}"
                    for k, (a, b) in sorted(differ.items())[:12]))
    k_served = sum(k_served.values())
    if not (np.all(np.isfinite(timed)) and timed.shape[0] == SERVE_TIMED):
        raise AssertionError("serving: the timed run is not finite")
    out.update(served_steps_per_s=served, live_steps_per_s=live,
               served_over_live=served / live,
               kernels_per_served_step=k_served,
               kernels_per_live_step=sum(k_live.values()))
    del m, sim

    # an int8 bundle
    sim, probe, q_build_s = slam_simulator(space, world, matmul_dtype="int8")
    sim.preload_inputs(SERVE_STEPS)
    rows = sim._preloaded
    save_bundle(sim, str(tmp / "int8"), segment_steps=SERVE_SEG)
    sim.run_steps(SERVE_STEPS, segment_steps=SERVE_SEG)
    (got,) = ServingModel(str(tmp / "int8"), device="cuda").run(
        rows).values()
    q_err = float(np.abs(got - sim.data[probe]).max())
    log(f"serving: int8 bundle ({bundle_mb(tmp / 'int8'):.1f} MB) vs its "
        f"live run over {SERVE_STEPS} steps from the start: max-abs "
        f"{q_err:.3e} (tol {REPLAY_TOL})")
    if not (np.all(np.isfinite(got)) and q_err <= REPLAY_TOL):
        raise AssertionError(f"serving: int8 served vs live {q_err}")
    out.update(int8_served_vs_live_max_abs=q_err,
               int8_bundle_mb=bundle_mb(tmp / "int8"))
    del sim
    shutil.rmtree(tmp, ignore_errors=True)

    stdout, seconds, launches = children["serving_probe"]
    res = last_json(stdout)
    keys = ("value", "live_engine_steps_per_s", "serving_over_live",
            "bundle_mb", "export_s")
    log(f"serving_probe {' '.join(SERVING_PROBE_ARGS)}: exit 0 in "
        f"{seconds:.1f} s (run with the untimed children); "
        + json.dumps({k: res.get(k) for k in keys}))
    if not all(isinstance(res.get(k), (int, float)) and np.isfinite(res[k])
               for k in keys):
        raise AssertionError(f"serving_probe printed {res}")
    out["serving_probe"] = dict({k: res[k] for k in keys}, seconds=seconds,
                                vco_scan_launches=launches)
    out["vco_scan_launches"] = vco_launches()
    if out["vco_scan_launches"] != 0:
        raise AssertionError(f"serving launched vco_scan "
                             f"{out['vco_scan_launches']} times")
    return out


def interpreter_phase(space, vco, children, live_steps_per_s):
    """Phase 26: the NumPy interpreter as an oracle at the flagship width:
    ``NumpyStepper`` on phase 11's model built with SSPSLAM_CLEANUP_F32=1
    against the card's Simulator over INTERP_STEPS steps, within the
    spike-flip bounds; the interpreter's steps/s on this host and the
    card's ratio to it; ``run_slam --backend numpy --T 0.3`` (run with the
    untimed children).  Returns the numbers and the simulator (phase 27
    traces it)."""
    from sspslam_tpu_torch.experiments.common import (slam_simulator,
                                                      slam_world)
    from sspslam_tpu_torch.nef.reference_backend import NumpyStepper
    reset_vco_launches()
    os.environ["SSPSLAM_CLEANUP_F32"] = "1"
    try:
        sim, probe, build_s = slam_simulator(space, slam_world())
    finally:
        del os.environ["SSPSLAM_CLEANUP_F32"]
    tables = [np.asarray(c) for c in sim._tabulate_inputs(INTERP_STEPS)]
    bp = next(p for p in sim.model.probes if p.obj is probe)
    t0 = time.perf_counter()
    ref = NumpyStepper(sim.model).run_steps(INTERP_STEPS, tables)[bp.index]
    interp = INTERP_STEPS / (time.perf_counter() - t0)
    sim.run_steps(INTERP_STEPS)
    card = sim.data[probe]
    st = spike_flip_check(card, ref, "interpreter vs card")
    log(f"interpreter (NumpyStepper, host) vs the card's Simulator, "
        f"{INTERP_STEPS} steps at the flagship width (float32 clean-up): "
        f"{json.dumps(st)}; the interpreter {interp:.2f} steps/s on this "
        f"host, the card {live_steps_per_s:.0f} (phase 25): "
        f"{live_steps_per_s / interp:.1f} x")
    out = {"build_s": build_s, "vs_card": st,
           "interpreter_steps_per_s": interp,
           "card_over_interpreter": live_steps_per_s / interp}
    stdout, seconds, launches = children["run_slam_numpy"]
    out["run_slam_numpy"] = cli_errors("run_slam --backend numpy", stdout,
                                       seconds, launches)
    out["vco_scan_launches"] = vco_launches()
    if out["vco_scan_launches"] != 0:
        raise AssertionError("the interpreter phase launched vco_scan")
    return out, sim


def host_phase(sim, vco):
    """Phase 27: the native host library built (g++, at first use) and
    loaded, each of its six functions equal to its NumPy fallback within
    tests/test_native.py's tolerances; ``trace_run`` around TRACE_STEPS
    replayed SLAM steps writes a Chrome trace naming the step's kernels."""
    from sspslam_tpu_torch import native
    from sspslam_tpu_torch.utils.profiling import trace_run
    reset_vco_launches()
    t0 = time.perf_counter()
    native.rd_sampling(4, 2)
    build_s = time.perf_counter() - t0
    if not native.AVAILABLE:
        raise AssertionError("the native host library did not build")
    rng = np.random.default_rng(SEED)
    traj = rng.normal(size=(50, 2))
    vecs = rng.normal(size=(200, 5, 2))
    data = rng.normal(size=(300, 31)).astype(np.float32)
    bank = rng.normal(size=(500, 31)).astype(np.float32)
    x = rng.normal(size=(400, 4)).astype(np.float32)
    J = np.linspace(-1, 10, 64).astype(np.float32)
    checks = {
        "rd_sampling": (native.rd_sampling(100, 3, 0.5),
                        native._rd_sampling_np(100, 3, 0.5), 0, 1e-12),
        "stretch_trajectory": (native.stretch_trajectory(traj, 0.02, 0.001),
                               native._stretch_trajectory_np(traj, 1000,
                                                             0.02), 0, 1e-9),
        "nearest_landmark": (np.concatenate(native.nearest_landmark(vecs,
                                                                    1.0)),
                             np.concatenate(native._nearest_landmark_np(
                                 vecs, 1.0)), 0, 1e-9),
        "argmax_decode": (native.argmax_decode(data, bank),
                          native._argmax_decode_np(data, bank), 0, 0),
        "lowpass_filter": (native.lowpass_filter(x, 0.05, 0.001),
                           native._lowpass_filter_np(
                               x, np.float32(np.exp(-0.001 / 0.05))), 0,
                           1e-5),
        "lif_rates": (native.lif_rates(J),
                      native._lif_rates_np(J, 0.02, 0.002, 1.0), 2e-4, 1e-3)}
    errs = {}
    for name, (got, want, rtol, atol) in checks.items():
        errs[name] = float(np.abs(got - want).max())
        if not (got.shape == want.shape and np.allclose(
                got, want, rtol=rtol, atol=atol)):
            raise AssertionError(f"native {name} differs from its fallback: "
                                 f"{errs[name]}")
    log(f"native host library: built and loaded in {build_s:.1f} s; "
        f"max-abs against the NumPy fallbacks: {errs}")

    tmp = Path(tempfile.mkdtemp(prefix="trace_"))
    sim.preload_inputs(2 * TRACE_STEPS)
    sim.run_steps(TRACE_STEPS, segment_steps=TRACE_STEPS)
    sim.sync()
    with trace_run(str(tmp)):
        sim.run_steps(TRACE_STEPS, segment_steps=TRACE_STEPS)
        sim.sync()
    (path,) = tmp.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    per_step = len(kernels) / TRACE_STEPS
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"trace_run around {TRACE_STEPS} replayed SLAM steps: "
        f"{per_step:.2f} kernels per step in the trace, "
        f"{len(set(kernels))} names")
    if per_step < 100:
        raise AssertionError(f"trace_run's trace holds {per_step} kernels "
                             f"per step")
    out = {"native_build_s": build_s, "native_vs_fallback_max_abs": errs,
           "trace_kernels_per_step": per_step,
           "trace_kernel_names": len(set(kernels)),
           "vco_scan_launches": vco_launches()}
    if out["vco_scan_launches"] != 0:
        raise AssertionError("the host phase launched vco_scan")
    return out




# ---------------------------------------------------------------------------
# Phases 28-30: the loop-closure, kidnap, map-merging and analysis CLIs
# ---------------------------------------------------------------------------
# 28. validate_loop_closure --tuned at its defaults: the flagship width and
# VALIDATION.md's protocol (ssp_dim 97, 800 per VCO, memory 970, 100 per
# convolution dimension, 50 landmarks, view radius 0.2, T = 200 s), held to
# tests/test_headline.py's bars
HEADLINE_ARGS = ("--tuned",)
HEADLINE_SLAM_MEDIAN = 0.08
HEADLINE_SLAM_LASTQ = 0.12
HEADLINE_SEPARATION = 3.0
# kidnapped_robot --in-model at tests/test_kidnap_regression.py's flags,
# held to its bars
KIDNAP_ARGS = ("--in-model", "--T", "60", "--ssp-dim", "55",
               "--pi-n-neurons", "250", "--mem-n-neurons", "500",
               "--circonv-n-neurons", "50", "--n-landmarks", "30",
               "--view-rad", "0.3", "--seed", "0")
KIDNAP_MIN_JUMP = 0.5
KIDNAP_DETECT_S = 27.0
KIDNAP_STRICT_LOST = 0.5
# the scripted schedule at the flagship width, dumped for
# check_anchor_enters, which queries the kidnap and the window's end
DUMP_ARGS = ("--T", "20", "--recovery-window", "4")
DUMP_ENTERS = ("10.0", "14.0")
# the in-process schedule: recovery entered at step 300, left at 600, of
# 1,000 steps
FLIP_IN, FLIP_OUT, FLIP_END = 300, 600, 1_000
# 29. the maps at the flagship widths.  A WhiteSignal path of T seconds
# needs a frequency bin 1/T under its limit: at the CLIs' default --limit
# 0.1 the 6 s test path stands still in one corner (and the JAX CLI, like
# the port's, then fails formatting the unvisited half's None), as do
# live_merge's 6.7 s and 3.3 s phases, so both move faster here
MERGE_ARGS = ("--T-explore", "10", "--T-test", "6", "--test-limit", "0.4",
              "--eval-gate", "auto_recovery")
LIVE_ARGS = ("--T", "10", "--exchange-s", "2", "--limit", "0.5")
MAP_STEPS = 1_000        # steps each in-process map is learned over
# 30. the analyses
FLAGSHIP_WIDTHS = ("--ssp-dim", str(SSP_DIM), "--pi-n-neurons",
                   str(N_NEURONS), "--mem-n-neurons", "970",
                   "--circonv-n-neurons", "100")
GATE_FIDELITY_ARGS = ("--T", "2", *FLAGSHIP_WIDTHS)
BF16_ARGS = ("--T", "10")
SCALE_ARGS = ("--dims", "97,193", "--steps", "2000", "--segment-steps",
              "1000", "--reps", "1")

def new_cli_jobs(work):
    """Phases 28-30's CLI children (their times are not reported): run
    with the untimed children, ``children_and_checks``; the kidnap dump is
    written into the directory ``work``."""
    dump = os.path.join(work, "kidnap_dump.npz")
    return {
        "validate_loop_closure": ("validate_loop_closure", *HEADLINE_ARGS),
        "kidnapped_in_model": ("kidnapped_robot", *KIDNAP_ARGS),
        "kidnapped_dump": ("kidnapped_robot", *DUMP_ARGS, "--dump", dump),
        "map_merge": ("map_merge", *MERGE_ARGS),
        "live_merge": ("live_merge", *LIVE_ARGS),
        "gate_fidelity": ("gate_fidelity", *GATE_FIDELITY_ARGS),
        "bf16_drift": ("bf16_drift", *BF16_ARGS),
        "scale_study": ("scale_study", *SCALE_ARGS)}


def _finite(obj, what):
    """Every number in a CLI's JSON value is finite (None allowed)."""
    vals = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            vals.append(float(x))
    walk(obj)
    if not vals or not np.all(np.isfinite(vals)):
        raise AssertionError(f"{what} printed non-finite numbers: {obj}")


def _json_line(stdout):
    return json.loads(next(line for line in reversed(stdout.splitlines())
                           if line.startswith("{")))


def recovery_schedule(vco):
    """Phase 28, in process: kidnapped_robot's three models at the flagship
    width (its defaults, a 1 s world), the scripted recovery window entered
    at step FLIP_IN and left at FLIP_OUT by in-place writes, FLIP_END
    steps: graph replay against the eager step through both flips (<=
    REPLAY_TOL on every probe), the graphs kept (no recapture), the params
    leaves the same tensors; and a replayed run without the window differs
    from the one with it (the writes reached the captured graphs)."""
    from sspslam_tpu_torch.experiments import kidnapped_robot as pk
    from sspslam_tpu_torch.nef import Simulator
    from sspslam_tpu_torch.nef.simulator import _flatten
    reset_vco_launches()
    args = pk.parse_args(["--T", "1", "--limit", "4", "--min-jump", "0.4"])
    world = pk.make_world(args)
    net, handles = pk.build_network(args, world)
    t0 = time.perf_counter()
    sim = Simulator(net, seed=args.seed, device="cuda")
    build_s = time.perf_counter() - t0
    enter, leave, _ = pk.recovery_controls(sim, handles["adaptive"], args)
    leaves = [(id(x), x.data_ptr()) for x in _flatten(sim.params)]
    dense = [bp for bp in sim.model.probes if not bp.sparse]
    sim.preload_inputs(FLIP_END)
    # probe buffers for the longest segment, so no segment reallocates them
    # (which would drop the graphs)
    sim.compile(FLIP_END)

    def run(eager, window):
        sim.reset(keep_inputs=True)
        sim.loop.eager = eager
        sim.run_steps(FLIP_IN)
        graphs = dict(sim.loop.graphs)
        if window:
            enter()
        sim.run_steps(FLIP_OUT - FLIP_IN)
        if window:
            leave()
        sim.run_steps(FLIP_END - FLIP_OUT)
        sim.sync()
        if not eager and any(sim.loop.graphs.get(k) is not g
                             for k, g in graphs.items()):
            raise AssertionError("the recovery writes recaptured a graph")
        return {bp.index: sim.data[bp.obj] for bp in dense}

    replay = run(False, True)
    eager = run(True, True)
    sim.loop.eager = False
    plain = run(False, False)
    if [(id(x), x.data_ptr()) for x in _flatten(sim.params)] != leaves:
        raise AssertionError("the recovery writes replaced a params leaf")
    err = max(float(np.abs(replay[k] - eager[k]).max()) for k in replay)
    a = replay[next(bp.index for bp in dense
                    if bp.obj is handles["probes"]["adaptive"])]
    b = plain[next(bp.index for bp in dense
                   if bp.obj is handles["probes"]["adaptive"])]
    moved = float(np.abs(a[FLIP_IN:] - b[FLIP_IN:]).max())
    before = float(np.abs(a[:FLIP_IN] - b[:FLIP_IN]).max())
    log(f"kidnapped_robot schedule in process (flagship, {FLIP_END} steps, "
        f"window {FLIP_IN}-{FLIP_OUT}; build {build_s:.1f} s): replay vs "
        f"eager through both flips, every probe: max-abs {err:.3e} (tol "
        f"{REPLAY_TOL}); adaptive PI with vs without the window: "
        f"{before:.3e} before step {FLIP_IN}, {moved:.3e} after")
    if not (all(np.all(np.isfinite(v)) for v in replay.values())
            and err <= REPLAY_TOL):
        raise AssertionError(f"recovery schedule: replay vs eager {err}")
    if not (before == 0.0 and moved > 0.0):
        raise AssertionError("the recovery window did not reach the "
                             f"graphs: {before}, {moved}")
    out = {"replay_vs_eager": err, "window_moved_adaptive": moved,
           "build_s": build_s, "vco_scan_launches": vco_launches()}
    del sim
    torch.cuda.empty_cache()
    if out["vco_scan_launches"] != 0:
        raise AssertionError("the recovery schedule launched vco_scan")
    return out


def loop_closure_phase(children, schedule, work):
    """Phase 28: the headline (validate_loop_closure --tuned at the
    flagship protocol) against tests/test_headline.py's bars; the kidnap
    (--in-model at tests/test_kidnap_regression.py's flags) against its
    bars; the flagship scripted kidnap with --dump and check_anchor_enters
    on its npz in ``work`` (finite); ``schedule``: recovery_schedule's
    result."""
    stdout, seconds, launches = children["validate_loop_closure"]
    r = _json_line(stdout)
    _finite(r, "validate_loop_closure")
    log(f"validate_loop_closure --tuned (flagship, T = {r['T']} s): "
        f"exit 0 in {seconds:.1f} s; SLAM median {r['slam_median']}, "
        f"last-q {r['slam_lastq']}, final {r['slam_final']}; PI median "
        f"{r['pi_median']}, last-q {r['pi_lastq']}, final {r['pi_final']} "
        f"(bars: SLAM < {HEADLINE_SLAM_MEDIAN} / < {HEADLINE_SLAM_LASTQ}, "
        f"PI > {HEADLINE_SEPARATION} x SLAM)")
    steps = next(l for l in stdout.splitlines() if l.startswith("sim:"))
    if not (r["T"] == 200.0 and r["ssp_dim"] == SSP_DIM
            and r["slam_median"] < HEADLINE_SLAM_MEDIAN
            and r["slam_lastq"] < HEADLINE_SLAM_LASTQ
            and r["pi_median"] > HEADLINE_SEPARATION * r["slam_median"]
            and r["pi_lastq"] > HEADLINE_SEPARATION * r["slam_lastq"]):
        raise AssertionError(f"validate_loop_closure misses the headline "
                             f"bars: {r}")
    out = {"headline": dict(r, seconds=seconds, sim_line=steps,
                            vco_scan_launches=launches)}

    stdout, seconds, launches = children["kidnapped_in_model"]
    k = _json_line(stdout)
    _finite({key: v for key, v in k.items() if key != "auto"}, "kidnap")
    auto = k["auto"]
    log(f"kidnapped_robot --in-model (test_kidnap_regression.py's flags): "
        f"exit 0 in {seconds:.1f} s; jump {k['jump']}, false triggers "
        f"{auto['false_triggers']}, detect {auto['detect_s']} s; post_err "
        f"adaptive {k['adaptive']['post_err']}, strict "
        f"{k['strict']['post_err']}, pi_only {k['pi_only']['post_err']}")
    if not (k["jump"] > KIDNAP_MIN_JUMP and auto["false_triggers"] == 0
            and auto["detect_s"] is not None
            and auto["detect_s"] <= KIDNAP_DETECT_S
            and k["adaptive"]["post_err"] < k["strict"]["post_err"]
            and k["strict"]["post_err"] > KIDNAP_STRICT_LOST):
        raise AssertionError(f"kidnapped_robot --in-model misses the "
                             f"regression bars: {k}")
    out["kidnap_in_model"] = dict(k, seconds=seconds,
                                  vco_scan_launches=launches)

    stdout, seconds, launches = children["kidnapped_dump"]
    s = _json_line(stdout)
    _finite(s, "kidnapped_robot --dump")
    dump = os.path.join(work, "kidnap_dump.npz")
    cout, cseconds, claunches = run_counted(
        "check_anchor_enters", dump, "--seed", "0", "--enters",
        *DUMP_ENTERS)
    rows = [[float(x.split("=")[1].rstrip("s:")) for x in l.split()[1:]]
            for l in cout.splitlines() if l.startswith("enter t=")]
    if len(rows) != len(DUMP_ENTERS) or not np.all(np.isfinite(rows)):
        raise AssertionError(f"check_anchor_enters printed {cout!r}")
    log(f"kidnapped_robot scripted (flagship, T = 20 s, window 4 s): exit 0 "
        f"in {seconds:.1f} s; jump {s['jump']}; post_err adaptive "
        f"{s['adaptive']['post_err']}, strict {s['strict']['post_err']}; "
        f"check_anchor_enters at {', '.join(DUMP_ENTERS)} s (t, err(at), "
        f"max, median): {rows}")
    out["kidnap_scripted"] = dict(s, seconds=seconds,
                                  vco_scan_launches=launches,
                                  check_anchor_enters=rows,
                                  check_anchor_enters_vco_scan_launches=
                                  claunches)
    out["schedule"] = schedule
    return out


def maps_phase(children, in_process):
    """Phase 29: map_merge and live_merge at the flagship widths (every
    condition and arm finite); ``in_process``: maps_in_process's
    result."""
    out = {"in_process": in_process}
    stdout, seconds, launches = children["map_merge"]
    m = _json_line(stdout)
    for cond in ("merged", "agent_A_only", "agent_B_only", "empty"):
        _finite(m[cond], f"map_merge {cond}")
    log(f"map_merge (flagship, explore 10 s, test 6 s at limit 0.4, "
        f"auto_recovery): "
        f"exit 0 in {seconds:.1f} s; median merged {m['merged']['median']}, "
        f"A only {m['agent_A_only']['median']}, B only "
        f"{m['agent_B_only']['median']}, empty {m['empty']['median']}")
    out["map_merge"] = dict(m, seconds=seconds, vco_scan_launches=launches)
    stdout, seconds, launches = children["live_merge"]
    lm = _json_line(stdout)
    for arm in ("exchange", "no_exchange"):
        for agent in ("agent_A", "agent_B"):
            _finite(lm["results"][arm][agent], f"live_merge {arm} {agent}")
    log(f"live_merge (flagship, T = 10 s, limit 0.5, exchange every 2 s): "
        f"exit 0 in "
        f"{seconds:.1f} s; crossover median with / without exchange: "
        + ", ".join(f"{a} {lm['results']['exchange'][a]['cross_median']} / "
                    f"{lm['results']['no_exchange'][a]['cross_median']}"
                    for a in ("agent_A", "agent_B")))
    out["live_merge"] = dict(lm, seconds=seconds, vco_scan_launches=launches)
    return out


def maps_in_process(vco):
    """Phase 29 in process: the merge of two learned maps of map_merge's
    flagship agent on the card against the JAX package's formula on the
    host (0), injected in place; one live exchange of live_merge's
    flagship batched episodes against A + B - M_prev (0) in both episodes,
    then MAP_STEPS replayed batched steps against eager steps from the
    exchanged state (<= REPLAY_TOL)."""
    from sspslam_tpu_torch.experiments import live_merge as pl
    from sspslam_tpu_torch.experiments import map_merge as pm
    from sspslam_tpu_torch.experiments.common import learned_base
    from sspslam_tpu_torch.nef.simulator import _flatten
    from sspslam_tpu_torch.parallel import BatchedEpisodes
    reset_vco_launches()
    args = pm.parse_args(["--T-explore", "2", "--T-test", "1"])
    world = pm.make_worlds(args)
    sim, _, _ = pm.build_program(args, world, world["paths"][0],
                                 world["vels"][0])
    sim.preload_inputs(2 * MAP_STEPS)
    base = learned_base(sim)
    sim.run_steps(MAP_STEPS)
    la = {k: v.clone() for k, v in sim.state["learned"].items()}
    sim.run_steps(MAP_STEPS)
    lb = {k: v.clone() for k, v in sim.state["learned"].items()}
    merged = pm.merge(la, lb, base)
    merge_err = 0.0
    for k in merged:
        a, b, c = (t[k].cpu().numpy() for t in (la, lb, base))
        merge_err = max(merge_err, float(np.abs(
            merged[k].cpu().numpy() - (c + (a - c) + (b - c))).max()))
    ids = [id(x) for x in _flatten(sim.state)]
    pm.inject(sim, {k.split("_")[0]: v for k, v in merged.items()})
    inject_err = max(float((sim.state["learned"][k] - merged[k]).abs().max())
                     for k in merged)
    if [id(x) for x in _flatten(sim.state)] != ids:
        raise AssertionError("inject replaced a state leaf")
    log(f"map_merge in process (flagship agent, maps after {MAP_STEPS} and "
        f"{2 * MAP_STEPS} steps): merge on the card vs the formula on the "
        f"host {merge_err:.3e}; injected in place {inject_err:.3e}")
    if merge_err != 0.0 or inject_err != 0.0:
        raise AssertionError(f"map merge: {merge_err}, {inject_err}")
    del sim
    torch.cuda.empty_cache()

    built = pl.build(pl.parse_args(["--T", "3", "--exchange-s", "1"]))
    runner = BatchedEpisodes(built["sim"], built["tables"])
    runner.run(MAP_STEPS)
    prev = {k: v.cpu().numpy()
            for k, v in learned_base(built["sim"]).items()}
    before = {k: v.cpu().numpy().copy()
              for k, v in runner.state["learned"].items()}
    base = learned_base(built["sim"])
    pl.exchange(runner, base)
    exch_err = 0.0
    for k, leaf in runner.state["learned"].items():
        want = before[k][0] + before[k][1] - prev[k]
        got = leaf.cpu().numpy()
        exch_err = max(exch_err, float(np.abs(got[0] - want).max()),
                       float(np.abs(got[1] - want).max()),
                       float(np.abs(base[k].cpu().numpy() - want).max()))
    snap = [x.clone() for x in _flatten(runner.state)]
    row = runner.n_steps
    p_idx = next(bp.index for bp in built["sim"].model.probes
                 if bp.obj is built["probe"])
    traces = {}
    for eager in (False, True):
        for x, s in zip(_flatten(runner.state), snap):
            x.copy_(s)
        runner.n_steps = row
        runner.loop.eager = eager
        traces[eager] = runner.run(MAP_STEPS)[p_idx].cpu().numpy()
        runner.sync()
    runner.loop.eager = False
    live_err = float(np.abs(traces[False] - traces[True]).max())
    log(f"live_merge in process (flagship, B = 2): one exchange after "
        f"{MAP_STEPS} steps vs A + B - M_prev: {exch_err:.3e}; the next "
        f"{MAP_STEPS} batched steps, replay vs eager: {live_err:.3e} (tol "
        f"{REPLAY_TOL})")
    if exch_err != 0.0 or not (np.all(np.isfinite(traces[False]))
                               and live_err <= REPLAY_TOL):
        raise AssertionError(f"live exchange: {exch_err}, {live_err}")
    out = {"merge_vs_formula": merge_err, "inject": inject_err,
           "exchange_vs_formula": exch_err,
           "after_exchange_replay_vs_eager": live_err,
           "vco_scan_launches": vco_launches()}
    del runner, built
    torch.cuda.empty_cache()
    if out["vco_scan_launches"] != 0:
        raise AssertionError("the map phase launched vco_scan")
    return out


def flagship_mflop(vco):
    """Phase 30 in process: MFLOP per step of bench.py --model slam's
    flagship model (``model_utilization_summary``), built here; returns it
    and the VCO kernel's launches."""
    from sspslam_tpu_torch import HexagonalSSPSpace
    from sspslam_tpu_torch.experiments.common import (slam_simulator,
                                                      slam_world)
    from sspslam_tpu_torch.utils.profiling import model_utilization_summary
    reset_vco_launches()
    sim, _, _ = slam_simulator(make_space(HexagonalSSPSpace),
                               slam_world(14.0, 10, SEED), device="cuda")
    mflop = round(sum(r["flops_per_step"]
                      for r in model_utilization_summary(sim.model)) / 1e6,
                  2)
    del sim
    torch.cuda.empty_cache()
    return mflop, vco_launches()


def analyses_phase(children, flagship, work):
    """Phase 30: gate_fidelity at the flagship widths (its engaged
    fractions), bf16_drift (the trajectory cosine finite, both steps/s
    printed), scale_study's rows (MFLOP/step at d = 97 equal to
    ``flagship``, flagship_mflop's result), and redecode_scaled on phase
    21's npz in ``work`` (polished median <= grid median)."""
    out = {}
    stdout, seconds, launches = children["gate_fidelity"]
    rows = [l.split() for l in stdout.splitlines()
            if l.startswith(("loihi ", "matched "))]
    engaged = {f"{r[0]} {r[1]}": {"median_err": float(r[2]),
                                  "engaged_frac": float(r[3])}
               for r in rows}
    _finite(engaged, "gate_fidelity")
    if len(engaged) != 3:
        raise AssertionError(f"gate_fidelity printed {stdout!r}")
    log(f"gate_fidelity (flagship widths, T = 2 s): exit 0 in "
        f"{seconds:.1f} s; {engaged}")
    out["gate_fidelity"] = {"rows": engaged, "seconds": seconds,
                            "vco_scan_launches": launches}

    stdout, seconds, launches = children["bf16_drift"]
    cos = [float(x) for x in next(
        l for l in stdout.splitlines() if l.startswith("f32-vs-bf16")
    ).replace(":", " ").split()[4::2]]
    rates = [float(l.split("(")[1].split()[0]) for l in stdout.splitlines()
             if l.startswith(("f32  :", "bf16 :"))]
    if len(cos) != 3 or len(rates) != 2 or not np.all(np.isfinite(cos)):
        raise AssertionError(f"bf16_drift printed {stdout!r}")
    log(f"bf16_drift (T = 10 s): exit 0 in {seconds:.1f} s; trajectory "
        f"cosine median / min / final {cos}; steps/s f32 {rates[0]}, bf16 "
        f"{rates[1]}")
    out["bf16_drift"] = {"cosine_median_min_final": cos,
                         "steps_per_s_f32_bf16": rates, "seconds": seconds,
                         "vco_scan_launches": launches}

    stdout, seconds, launches = children["scale_study"]
    table = [[c.strip() for c in l.strip("|").split("|")]
             for l in stdout.splitlines()
             if l.startswith("| ") and l[2].isdigit()]
    want, summary_launches = flagship
    got = [float(r[3]) for r in table if r[0] == str(SSP_DIM)]
    log(f"scale_study --dims 97,193: exit 0 in {seconds:.1f} s; rows (d, "
        f"neurons, dtype, MFLOP/step, steps/s, us/step): {table}; "
        f"MFLOP/step of the flagship model built here: {want}")
    if len(table) != 4 or got != [want, want]:
        raise AssertionError(f"scale_study rows {table} against {want}")
    out["scale_study"] = {"rows": table, "mflop_flagship": want,
                          "seconds": seconds, "vco_scan_launches": launches,
                          "summary_vco_scan_launches": summary_launches}

    (npz,) = [os.path.join(work, f) for f in os.listdir(work)
              if f.startswith("scaled_slam_")]
    stdout, seconds, launches = run_counted("redecode_scaled", npz)
    r = _json_line(stdout)
    log(f"redecode_scaled on phase 21's npz: exit 0 in {seconds:.1f} s; "
        f"median grid {r['median_grid']}, polished {r['median_polished']}")
    if not (np.isfinite(r["median_polished"])
            and r["median_polished"] <= r["median_grid"]):
        raise AssertionError(f"redecode_scaled: {r}")
    out["redecode_scaled"] = dict(r, seconds=seconds,
                                  vco_scan_launches=launches)
    return out


SHARDS = (1, 2, 4, 7)     # oscillator shards of the sharded scan (phase 31)
SHARD_REPEATS = 3         # timed chunks per shard count
DEMO_REPLAY = 300         # each demo's replay vs eager steps (phase 32)
# the demos at their scripts' default widths, shortened runs: a path of
# 10 s at the default --limit 0.1 moves (one component), and slam_map_new's
# WhiteSignal of high 0.05 Hz needs T >= 20 s
DEMOS = (("run_pathint_gif", ("--T", "10")),
         ("run_slam_map_gif", ("--T", "10")),
         ("slam_map_new", ("--T", "20")))
# slam_map_new's tracking cosine against the JAX script's at T = 20 s (the
# most one world moves with rounding alone, PERF.md §6)
MAP_NEW_TRACKING_TOL = 0.04


def sharded_scan(vco, fpi, space, unsharded, unsharded_ms, num_sms):
    """Phase 31: ``parallel.make_sharded_vco_scan`` at the main path's
    width (ssp_dim 97, k = 49, 800 LIF per VCO) for every S of SHARDS:
    against the plain sharded scan on the card over SHORT steps (max-abs
    <= SHORT_TOL), then one CHUNK-step chunk of the main path's traffic
    from the zero state, counted (S launches), against ``unsharded`` (the
    unsharded kernel's trace of the same chunk, phase 3: median |diff|
    <= LONG_MEDIAN_TOL, decoded positions at the chunk end within
    DRIFT_TOL), then ms per chunk by CUDA events (SHARD_REPEATS chunks
    after that one).  Returns {S: numbers}."""
    from sspslam_tpu_torch.parallel import make_sharded_vco_scan
    d = fpi.d
    vel_c = torch.tensor(traffic()[:CHUNK], device="cuda")
    corr_c = torch.zeros((CHUNK, d), dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(1)
    vel_s = torch.tensor(0.02 * rng.normal(size=(SHORT, 2)),
                         dtype=torch.float32, device="cuda")
    corr_s = torch.zeros((SHORT, d), dtype=torch.float32, device="cuda")
    corr_s[:20] = torch.tensor(space.encode(np.array([[0.1, -0.2]])).ravel(),
                               dtype=torch.float32)
    end_ref = decode(space, unsharded[-1:].cpu().numpy())
    results = {}
    for S in SHARDS:
        short = make_sharded_vco_scan(fpi.params, S, SHORT)
        _, y_k = short(short.initial_state(), vel_s, corr_s)
        y_p = None
        for p, s0 in zip(short.shards, short.initial_state()):
            _, y = vco.vco_scan_reference(p, s0, vel_s, corr_s)
            y_p = y if y_p is None else y_p + y
        err = float((y_k - y_p).abs().max())
        if not err <= SHORT_TOL:
            raise AssertionError(f"sharded scan S={S}: kernel vs plain "
                                 f"{err} > {SHORT_TOL}")
        run = make_sharded_vco_scan(fpi.params, S, CHUNK)
        k_shard = run.shards[0].bias.shape[1]
        state0 = run.initial_state()
        reset_vco_launches()
        _, y = run(state0, vel_c, corr_c)
        torch.cuda.synchronize()
        launches = vco_launches()
        if launches != S:
            raise AssertionError(f"sharded scan S={S}: {launches} kernel "
                                 f"launches for one chunk, not {S}")
        diff = (y - unsharded).abs()
        med = float(diff.median())
        dist = float(np.linalg.norm(decode(space, y[-1:].cpu().numpy())
                                    - end_ref))
        if not (med <= LONG_MEDIAN_TOL and dist <= DRIFT_TOL):
            raise AssertionError(f"sharded scan S={S} vs the unsharded "
                                 f"kernel: median {med}, decoded "
                                 f"difference {dist}")
        ms, _ = cuda_ms(lambda: run(state0, vel_c, corr_c), SHARD_REPEATS)
        results[str(S)] = {
            "oscillators_per_shard": k_shard,
            "cluster": vco._cluster_size(fpi.n, k_shard, num_sms),
            "launches_per_chunk": launches, "max_abs_vs_plain": err,
            "median_vs_unsharded": med,
            "max_abs_vs_unsharded": float(diff.max()),
            "decoded_diff_vs_unsharded": dist, "ms": ms}
        log(f"sharded scan S={S} ({k_shard} VCOs a shard, C="
            f"{results[str(S)]['cluster']}): kernel vs plain, {SHORT} "
            f"steps: max-abs {err:.3e} (tol {SHORT_TOL}); {launches} "
            f"launches a chunk; vs the unsharded kernel over {CHUNK} "
            f"steps: "
            f"median {med:.3e} (tol {LONG_MEDIAN_TOL}), max-abs "
            f"{float(diff.max()):.3e}, decoded difference at the end "
            f"{dist:.4f} (tol {DRIFT_TOL}); {ms:.3f} ms a chunk (unsharded "
            f"{unsharded_ms:.3f})")
        del run, short
    return results


def demo_replay(sim, what, steps=DEMO_REPLAY):
    """Graph replay against the eager step over ``steps`` steps from the
    fresh state: every probe (dense traces and sparse snapshots of learned
    weights) and every state leaf; returns the max-abs difference."""
    from sspslam_tpu_torch.nef.simulator import _flatten
    runs = {}
    for eager in (False, True):
        sim.reset()
        sim.loop.eager = eager
        with contextlib.redirect_stdout(io.StringIO()):
            sim.run_steps(steps)
        sim.sync()
        runs[eager] = ([sim.data[bp.obj] for bp in sim.model.probes],
                       [x.detach().cpu().double().numpy()
                        for x in _flatten(sim.state)])
    sim.loop.eager = False
    sim.reset()
    err, sparse = 0.0, 0
    for bp, a, b in zip(sim.model.probes, runs[False][0], runs[True][0]):
        if a.shape != b.shape or not np.all(np.isfinite(a)):
            raise AssertionError(f"{what}: probe {bp.index} replayed "
                                 f"{a.shape}, eager {b.shape}, or not "
                                 f"finite")
        sparse += bool(bp.sparse and a.size)
        if a.size:
            err = max(err, float(np.abs(a - b).max()))
    for a, b in zip(*(runs[e][1] for e in (False, True))):
        if a.size:
            err = max(err, float(np.abs(a - b).max()))
    log(f"{what}: graph replay vs eager step, {steps} steps, every probe "
        f"({sparse} sparse snapshots of learned weights) and state leaf: "
        f"max-abs {err:.3e} (tol {REPLAY_TOL})")
    if not err <= REPLAY_TOL:
        raise AssertionError(f"{what}: graph replay differs from the eager "
                             f"step: {err}")
    return err


def _all_finite(what, *arrays):
    for a in arrays:
        if not np.all(np.isfinite(np.asarray(a, np.float64))):
            raise AssertionError(f"{what}: non-finite output")


def map_new_vs_jax(ref, res, T):
    """slam_map_new's card run against the JAX script's printed numbers
    at the same T (``tests/make_jax_reference.py``): tracking within
    MAP_NEW_TRACKING_TOL, item errors printed."""
    jax_cos = float(ref["slam_map_new_tracking"])
    jax_errs = [float(e) for e in ref["slam_map_new_item_errors"]]
    errs = [float(e) for e in res["item_errors"]]
    log(f"  slam_map_new at T = {T:g} s vs the JAX script's: tracking "
        f"{res['tracking']:.4f} against {jax_cos:.3f} (tol "
        f"{MAP_NEW_TRACKING_TOL}); item errors "
        f"{[round(e, 3) for e in errs]} against {jax_errs} (printed)")
    if not abs(res["tracking"] - jax_cos) <= MAP_NEW_TRACKING_TOL:
        raise AssertionError(f"slam_map_new tracking {res['tracking']} "
                             f"against the JAX script's {jax_cos}")
    return {"jax_tracking": jax_cos, "jax_item_errors": jax_errs}


def demos_phase(vco, ref):
    """Phase 32, in process: the three simulating demos' ``build`` and
    ``simulate`` (what their scripts run before rendering) on the card at
    their default widths: replay vs eager over DEMO_REPLAY steps
    (``demo_replay``), then a shortened run (DEMOS' flags) timed by the
    scripts' own ``simulate``, its arrays finite; slam_map_new's tracking
    cosine, item errors and area-query sims printed, and its tracking
    within MAP_NEW_TRACKING_TOL of the JAX script's at the same T and
    widths (the JAX reference ``ref``), its item errors printed beside
    JAX's.  The VCO kernel launches 0 times.  Returns {demo: numbers}."""
    import importlib
    results = {}
    reset_vco_launches()
    for name, flags in DEMOS:
        mod = importlib.import_module(
            f"sspslam_tpu_torch.experiments.{name}")
        args = mod.parse_args(list(flags))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            built = mod.build(args)
        build_s = time.perf_counter() - t0
        sim = built["sim"]
        err = demo_replay(sim, name)
        with contextlib.redirect_stdout(io.StringIO()):
            res = mod.simulate(args, built)
        out = {"T": float(args.T), "build_s": build_s,
               "neurons": int(sum(be.n * (be.k if be.batched else 1)
                                  for be in sim.model.ensembles)),
               "replay_vs_eager": err, "steps_per_s": res["steps_per_s"],
               "seconds": res["seconds"]}
        if name == "run_pathint_gif":
            _all_finite(name, res["out"], res["osc"], res["sims"])
            out["raster"] = list(res["raster"].shape)
        elif name == "run_slam_map_gif":
            _all_finite(name, res["out"], res["posterior"], res["maps"],
                        res["weights"], res["encoders"])
            out["frames"] = int(len(res["maps"]))
        else:
            _all_finite(name, res["out"], res["item_errors"],
                        res["area_sims"], [res["tracking"]])
            out.update(tracking=res["tracking"],
                       item_errors=[float(e) for e in res["item_errors"]],
                       blue_triangle_error=res["blue_triangle_error"],
                       area_sims=[float(x) for x in res["area_sims"]])
            for line in res["lines"]:
                log(f"  {name}: {line.strip()}")
            out.update(map_new_vs_jax(ref, res, float(args.T)))
        log(f"{name} (T = {args.T} s, {out['neurons']} neurons): build "
            f"{build_s:.1f} s, {res['steps_per_s']:.0f} steps/s "
            f"({res['seconds']:.1f} s)")
        results[name] = out
        del built, sim, res
        torch.cuda.empty_cache()
    results["vco_scan_launches"] = vco_launches()
    if results["vco_scan_launches"] != 0:
        raise AssertionError("the demos launched the VCO kernel")
    return results


# ---------------------------------------------------------------------------
# Phase 33: the port's benchmark and its device-time and roofline probes
# ---------------------------------------------------------------------------
BENCH_SLAM_ARGS = ("--model", "slam", "--reps", "1", "--timed-steps",
                   "10000", "--baseline-reps", "1", "--no-scaled-spot")
# --model pi-fast at the defaults: one 10,000-step warm-up chunk and five
# timed chunks
BENCH_PI_FAST_LAUNCHES = 6


def quiet_main(module, argv):
    """``module.main(argv)`` with its standard output kept from this
    script's (its log lines go to standard error); returns main's row."""
    with contextlib.redirect_stdout(io.StringIO()):
        return module.main(list(argv))


def bench_phase(vco, slam):
    """Phase 33 (see the module docstring); ``slam`` is phase 11's
    numbers.  Returns the numbers of the bench JSON line."""
    from sspslam_tpu_torch import bench
    from sspslam_tpu_torch.experiments import step_roofline
    from sspslam_tpu_torch.experiments.device_time_probe import \
        profile_steps as profiled
    out = {}

    # --model pi-fast: the wrapper's count, the bench row's and the trace's
    plain_calls = []
    real_plain = vco.vco_scan_reference

    def counted_plain(*a):
        plain_calls.append(1)
        return real_plain(*a)
    rows = []
    vco.vco_scan_reference = counted_plain
    reset_vco_launches()
    t0 = time.perf_counter()
    try:
        trace = profiled(lambda: rows.append(
            quiet_main(bench, ["--model", "pi-fast"])), 1, top=None)
    finally:
        vco.vco_scan_reference = real_plain
    launches = vco_launches()
    row = rows[0]
    traced = sum(calls for name, _, calls in trace["top"]
                 if "vco_scan_kernel" in name)
    log(f"bench --model pi-fast: {row['value']:.0f} steps/s in "
        f"{time.perf_counter() - t0:.1f} s; vco_scan launches {launches} "
        f"(row {row['vco_scan_launches']}, traced {traced:.0f}), plain "
        f"version calls {len(plain_calls)}; {row['device_name']}, "
        f"{row['power_limit_w']} W")
    if not (launches == row["vco_scan_launches"] == traced
            == BENCH_PI_FAST_LAUNCHES and not plain_calls
            and row["platform"] == "gpu" and row["value"] > 0):
        raise AssertionError(f"bench --model pi-fast: {launches} launches "
                             f"(row {row['vco_scan_launches']}, traced "
                             f"{traced}), {len(plain_calls)} plain calls, "
                             f"row {row}")
    out["pi_fast"] = {"steps_per_s": row["value"], "vco_scan_launches":
                      launches, "traced_launches": traced,
                      "plain_calls": len(plain_calls)}

    # --model slam, shortened
    reset_vco_launches()
    t0 = time.perf_counter()
    row = quiet_main(bench, BENCH_SLAM_ARGS)
    seconds = time.perf_counter() - t0
    launches = vco_launches()
    log(f"bench {' '.join(BENCH_SLAM_ARGS)}: {json.dumps(row)}")
    log(f"bench --model slam: {row['value']:.0f} steps/s, tracking "
        f"{row['tracking_cosine']:.4f}, device {row['device_us_per_step']} "
        f"us/step, {row['flops_per_step']:.0f} FLOP/step (phase 11: "
        f"{slam['flops_per_step']:.0f}), mfu {row['mfu']:.3e}, vs_baseline "
        f"{row['vs_baseline']}; {seconds:.1f} s; vco_scan launches "
        f"{launches}")
    if not (row["platform"] == "gpu" and row["accuracy_pass"]
            and row["device_us_per_step"] is not None
            and row["device_us_per_step"] > 0
            and row["flops_per_step"] == slam["flops_per_step"]
            and row["mfu"] > 0 and row["vs_baseline"] is not None
            and np.isfinite(row["vs_baseline"]) and launches == 0
            and row["vco_scan_launches"] == 0):
        raise AssertionError(f"bench --model slam: {row}, {launches} VCO "
                             f"launches")
    out["slam"] = dict(row, seconds=seconds)

    # the roofline of the same model, beside the bench's device time
    reset_vco_launches()
    t0 = time.perf_counter()
    sim = bench.build(bench.parse_args([]))[0]
    roof = step_roofline.roofline(sim, row["device_us_per_step"])
    del sim
    launches = vco_launches()
    log(f"step_roofline: {json.dumps(roof)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (roof["flops_per_step"] == slam["flops_per_step"]
            and roof["bound_by"] in ("bytes", "operations")
            and 0 < roof["roofline_us_per_step"]
            < roof["measured_us_per_step"] and launches == 0):
        raise AssertionError(f"step_roofline: {roof}, {launches} VCO "
                             f"launches")
    out["roofline"] = roof
    out["vco_scan_launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 34: the card against the JAX package's full-width reference
# ---------------------------------------------------------------------------
# Made on the CPU from the JAX package by tests/make_jax_reference.py; the
# card's machine has no JAX, so the reference travels as this file.
REFERENCE = Path(__file__).resolve().parent / "tests" / "reference" / \
    "full_width_jax.npz"
HOST_LEAF_RTOL = 1e-6     # host solves and seeded draws (the same NumPy)
DEVICE_LEAF_RTOL = 1e-4   # float32 device solves (test_torch_builder.py)
# one world's tracking cosine moves by up to 0.04 with rounding alone
# (PERF.md §6); the mean of five worlds by that over sqrt(5)
TRACKING_SEED_TOL = 0.04
TRACKING_MEAN_TOL = 0.02
REFERENCE_SEEDS = (0, 1, 2, 3, 4)   # the SLAM worlds of the reference
REFERENCE_ROWS = 300      # the first rows held to the spike-flip bounds
EVERY = 1_000             # the rows decoded against the reference's


def load_reference():
    """The reference's arrays, {key: ndarray}."""
    with np.load(REFERENCE) as f:
        return {k: f[k] for k in f.files}


def flat_leaves(tree, path=""):
    """(slash path, leaf) of a parameter tree as the reference's generator
    walks the JAX package's: dict keys sorted, list and tuple items by
    index, a NamedTuple by field name."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from flat_leaves(getattr(tree, k),
                                   f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def leaf_checksum(x):
    """[sum, L2 norm, L1 norm, weighted sum] of a leaf (tensor of any dtype
    and device, array or number), in float64 on the host.  The weighted
    sum, of the flattened leaf with the weights ``arange(n) % 7 + 1``,
    changes when a leaf's values are permuted or transposed; the other
    three do not."""
    if torch.is_tensor(x):
        a = x.detach().to("cpu", torch.float64).reshape(-1).numpy()
    else:
        a = np.asarray(x, np.float64).reshape(-1)
    weights = np.arange(a.size) % 7 + 1
    return np.array([a.sum(), np.sqrt(np.sum(a * a)), np.abs(a).sum(),
                     np.dot(a, weights)])


def check_leaf_sums(params, paths, sums, device, what):
    """The checksums of ``params`` against the reference's (``paths``,
    ``sums``, ``device``): the same leaf paths, and for each leaf
    |sum - ref| / ref L1, |L2 - ref| / ref L2 and |weighted sum - ref| /
    ref L1 within HOST_LEAF_RTOL, or DEVICE_LEAF_RTOL for decoders solved
    in float32 on a device.  Returns the worst relative error of each
    kind."""
    own = dict(flat_leaves(params))
    paths = [str(p) for p in paths]
    if set(own) != set(paths):
        raise AssertionError(f"{what}: leaf paths differ: port only "
                             f"{sorted(set(own) - set(paths))}, reference "
                             f"only {sorted(set(paths) - set(own))}")

    def rel(diff, scale):
        return diff / scale if scale > 0 else (0.0 if diff == 0 else np.inf)

    worst = {"host": 0.0, "device": 0.0}
    for path, want, dev in zip(paths, sums, device):
        got = leaf_checksum(own[path])
        err = max(rel(abs(got[0] - want[0]), want[2]),
                  rel(abs(got[1] - want[1]), want[1]),
                  rel(abs(got[3] - want[3]), want[2]))
        kind = "device" if dev else "host"
        tol = DEVICE_LEAF_RTOL if dev else HOST_LEAF_RTOL
        if not err <= tol:
            raise AssertionError(f"{what}: leaf {path} ({kind} solve): "
                                 f"checksum {got.tolist()} against "
                                 f"{list(want)}, relative {err} > {tol}")
        worst[kind] = max(worst[kind], err)
    return worst


def check_first_rows(trace, want, what):
    """The first REFERENCE_ROWS rows of a SLAM probe ``trace`` against the
    reference's ``want``: spike_flip_check's q80 and peak bounds and the
    median below SPIKE_ATOL (the other two bounds are not held: one
    near-threshold spike flip breaks them).  Returns spike_flip_stats."""
    st = spike_flip_check(trace[:REFERENCE_ROWS], want, what, whole=False)
    if not st["median"] < SPIKE_ATOL:
        raise AssertionError(f"{what}: median {st['median']} of the first "
                             f"{REFERENCE_ROWS} rows >= {SPIKE_ATOL}: {st}")
    return st


def first_above(dists, steps, tol):
    """The first step whose distance passes ``tol``, or None."""
    over = np.flatnonzero(np.asarray(dists) > tol)
    return int(steps[over[0]]) if over.size else None


def reference_fast(ref, fpi, space, trace):
    """Phase 34, fast path (no extra card time): phase 5's main-path run of
    60,000 steps against JAX's Pallas kernel in interpret mode over the same
    velocities: the built parameters' checksums; the first 40 rows within
    SHORT_TOL; the decoded position at each of the six chunk ends within
    DRIFT_TOL of JAX's; the median |diff| of the rows at every 1,000th step
    printed beside LONG_MEDIAN_TOL.  Returns the numbers."""
    worst = check_leaf_sums(fpi.params, ref["fast_leaf_paths"],
                            ref["fast_leaf_sums"], ref["fast_leaf_device"],
                            "fast path")
    first = float(np.abs(trace[:SHORT] - ref["fast_rows40"]).max())
    rows = trace[EVERY - 1::EVERY]
    med = float(np.median(np.abs(rows - ref["fast_rows_every1000"])))
    ends = decode(space, trace[CHUNK - 1::CHUNK])
    dists = np.linalg.norm(ends - ref["fast_decoded_every10000"], axis=1)
    log(f"reference, fast path vs JAX's Pallas kernel (interpret mode) over "
        f"{len(trace)} steps: leaf checksums host {worst['host']:.2e} (tol "
        f"{HOST_LEAF_RTOL}), device-solved {worst['device']:.2e} (tol "
        f"{DEVICE_LEAF_RTOL}); first {SHORT} rows max-abs {first:.3e} (tol "
        f"{SHORT_TOL}); every {EVERY}th row median |diff| {med:.3e} (printed "
        f"beside {LONG_MEDIAN_TOL}); decoded chunk ends "
        f"{[round(float(x), 4) for x in dists]} (tol {DRIFT_TOL})")
    if not (first <= SHORT_TOL and np.all(dists <= DRIFT_TOL)):
        raise AssertionError(f"fast path vs JAX: first {SHORT} rows {first},"
                             f" chunk-end decoded distances {dists}")
    return {"leaf_rel_err": worst, "first_rows_max_abs": first,
            "every_1000_median_abs": med,
            "chunk_end_decoded_diff": [float(x) for x in dists]}


def reference_slam(ref, vco):
    """Phase 34, SLAM: for each of REFERENCE_SEEDS, ``bench.build`` on
    the card (TF32 off) and the 14,000-step world replayed from the fresh
    state: the build's parameter checksums; the first REFERENCE_ROWS probe
    rows against JAX's by the spike-flip bounds (median, q80 and peak held;
    the other two printed); the tracking cosine within TRACKING_SEED_TOL of
    JAX's, and the five seeds' means within TRACKING_MEAN_TOL; the decoded
    position at every EVERY-th step against JAX's (largest, median, first
    step past DRIFT_TOL; printed).  Both sides keep the bf16 clean-up.
    Launches the VCO kernel 0 times.  Returns the numbers."""
    from sspslam_tpu_torch import bench
    t0 = time.perf_counter()
    reset_vco_launches()
    out = {}
    for s in REFERENCE_SEEDS:
        p = f"slam_s{s}_"
        t1 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            sim, probe, space, path = bench.build(
                bench.parse_args(["--device", "cuda", "--seed", str(s)]))
        build_s = time.perf_counter() - t1
        worst = check_leaf_sums(sim.params, ref[p + "leaf_paths"],
                                ref[p + "leaf_sums"], ref[p + "leaf_device"],
                                f"SLAM seed {s}")
        sim.run_steps(WORLD_STEPS)
        trace = sim.data[probe]
        if not (trace.shape == (WORLD_STEPS, space.ssp_dim)
                and np.all(np.isfinite(trace))):
            raise AssertionError(f"SLAM seed {s}: trace {trace.shape} is "
                                 f"not finite")
        cos = tracking_cosine(space, trace, path)
        jax_cos = float(ref[p + "tracking"])
        flips = check_first_rows(trace, ref[p + "rows300"], f"SLAM seed {s}")
        steps = np.arange(EVERY - 1, WORLD_STEPS, EVERY)
        dists = np.linalg.norm(decode(space, trace[steps]) -
                               ref[p + "decoded_every1000"], axis=1)
        seconds = time.perf_counter() - t1
        log(f"reference, SLAM seed {s}: build {build_s:.1f} s, leaf "
            f"checksums host {worst['host']:.2e}, device-solved "
            f"{worst['device']:.2e}; first {REFERENCE_ROWS} rows "
            f"median {flips['median']:.2e} (tol {SPIKE_ATOL}), q80 "
            f"{flips['q80']:.2e} (tol {5 * SPIKE_ATOL}), peak "
            f"{flips['peak']:.2e} (tol 0.25), printed: above 5 atol "
            f"{flips['above_5_atol']:.3f}, longest run "
            f"{flips['longest_run']}, first differing step "
            f"{flips['first_differing_step']}; tracking port {cos:.4f}, JAX "
            f"{jax_cos:.4f}, |diff| {abs(cos - jax_cos):.4f} (tol "
            f"{TRACKING_SEED_TOL}); decoded every {EVERY}th step: largest "
            f"{dists.max():.4f}, median {np.median(dists):.4f}, first past "
            f"{DRIFT_TOL} at step {first_above(dists, steps, DRIFT_TOL)}; "
            f"{seconds:.1f} s")
        if not abs(cos - jax_cos) <= TRACKING_SEED_TOL:
            raise AssertionError(f"SLAM seed {s}: tracking {cos} against "
                                 f"JAX's {jax_cos}")
        out[str(s)] = {"tracking": cos, "jax_tracking": jax_cos,
                       "build_s": build_s, "leaf_rel_err": worst,
                       "first_rows": flips,
                       "decoded_diff_max": float(dists.max()),
                       "decoded_diff_median": float(np.median(dists)),
                       "decoded_first_past_tol": first_above(dists, steps,
                                                             DRIFT_TOL),
                       "seconds": seconds}
        del sim, trace
        torch.cuda.empty_cache()
    mean_port = float(np.mean([r["tracking"] for r in out.values()]))
    mean_jax = float(np.mean([r["jax_tracking"] for r in out.values()]))
    launches = vco_launches()
    seconds = time.perf_counter() - t0
    log(f"reference, SLAM over seeds {list(REFERENCE_SEEDS)}: mean tracking "
        f"port {mean_port:.4f}, JAX {mean_jax:.4f}, |diff| "
        f"{abs(mean_port - mean_jax):.4f} (tol {TRACKING_MEAN_TOL}); "
        f"{launches} VCO launches; {seconds:.1f} s")
    if not abs(mean_port - mean_jax) <= TRACKING_MEAN_TOL:
        raise AssertionError(f"SLAM mean tracking {mean_port} against JAX's "
                             f"{mean_jax}")
    if launches != 0:
        raise AssertionError(f"the reference's SLAM runs launched vco_scan "
                             f"{launches} times")
    return {"seeds": out, "mean_tracking": mean_port,
            "jax_mean_tracking": mean_jax,
            "mean_tracking_diff": mean_port - mean_jax,
            "vco_scan_launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# 36. The program's spans on the fast path
# ---------------------------------------------------------------------------

EPISODE = 2 * CHUNK   # the benchmark cell's episode: two launches
TRACE_EPISODES = 20   # episodes under the profiler (the cell's traced slice)
ORDER_EPISODES = 3    # episodes in trace_run's Chrome trace
COST_PAIRS = 8        # tracing off and on, in turns
COST_EPISODES = 20    # episodes a side of a pair
ACCOUNT_TOL = 0.03    # pi.run + pi.initial_state against the episode
WAIT_RANGE = (1.8, 2.05)  # pi.wait over the kernel's mean record time


def episode_inputs(space, d):
    """One episode's velocity and correction tables, as the benchmark's
    entry uploads them (the clamp rows over the first 50 ms)."""
    corr = np.zeros((EPISODE, d), np.float32)
    corr[:49] = space.encode(np.array([[0.15, -0.1]]))
    return traffic()[:EPISODE], corr


def episodes(fpi, vel, corr, n):
    """``n`` episodes as the benchmark's entry runs them (the bank from
    rest, the whole trace to the host); each one's ns on the host clock."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        fpi.state = fpi.initial_state()
        fpi.run(vel, corr)
        times.append(time.perf_counter_ns() - t0)
    return times


def traced_split(fpi, vel, corr):
    """TRACE_EPISODES episodes under ``torch.profiler``: the mean of each
    span an episode and the kernel's records, checked: two
    ``vco_scan.call`` a ``pi.run``, ``pi.run`` + ``pi.initial_state``
    within ACCOUNT_TOL of the episode, ``pi.wait`` within WAIT_RANGE of
    the kernel's mean record, no device record named after a span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sspslam_tpu_torch.experiments.device_time_probe import busy_ns
    from sspslam_tpu_torch.utils import profiling
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.time_ns()
        ep = episodes(fpi, vel, corr, TRACE_EPISODES)
        w1 = time.time_ns()
    recs = profiling.spans()
    dev = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not getattr(e, "is_hidden_event", lambda: False)()]
    kernel = [b - a for n, a, b in dev if "vco_scan" in n]
    runs = [i for i, r in enumerate(recs) if r.name == "pi.run"]
    calls = [sum(1 for r in recs if r.parent == i
                 and r.name == "vco_scan.call") for i in runs]

    def per_episode(name):
        return sum(r.end_ns - r.start_ns for r in recs
                   if r.name == name) / TRACE_EPISODES / 1e6
    out = {"episodes": TRACE_EPISODES,
           "episode_ms": float(np.mean(ep)) / 1e6,
           "kernel_ms": float(np.mean(kernel)) / 1e6,
           "kernels_per_episode": len(kernel) / TRACE_EPISODES,
           **{f"{n}_ms": per_episode(n) for n in (
               "pi.initial_state", "pi.run", "pi.upload", "vco_scan.call",
               "pi.wait", "pi.download")},
           "vco_scan_call_us": 1e3 * per_episode("vco_scan.call")
           * TRACE_EPISODES / max(1, sum(calls)),
           "pi.run_self_ms": sum(profiling.self_ns(recs, i)
                                 for i in runs) / TRACE_EPISODES / 1e6,
           "device_idle_share": 1 - busy_ns(
               [(a, b) for _, a, b in dev], w0, w1) / (w1 - w0)}
    out["outside_pi.run_ms"] = (out["episode_ms"] - out["pi.run_ms"]
                                - out["pi.initial_state_ms"])
    out["account"] = (out["pi.run_ms"] + out["pi.initial_state_ms"]) \
        / out["episode_ms"]
    out["wait_over_kernel"] = out["pi.wait_ms"] / out["kernel_ms"]
    log("traced split of an episode (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    named = sorted({n for n, _, _ in dev
                    if n.startswith("pi.") or n == "vco_scan.call"})
    if named:
        raise AssertionError(f"device records named after spans: {named}")
    if calls != [2] * TRACE_EPISODES:
        raise AssertionError(f"vco_scan.call spans a pi.run: {calls}")
    if abs(out["account"] - 1) > ACCOUNT_TOL:
        raise AssertionError(f"pi.run + pi.initial_state cover "
                             f"{out['account']:.4f} of the episode")
    if not WAIT_RANGE[0] <= out["wait_over_kernel"] <= WAIT_RANGE[1]:
        raise AssertionError(f"pi.wait is {out['wait_over_kernel']:.3f} x "
                             f"the kernel's record")
    return out


def chrome_trace_order(fpi, vel, corr):
    """ORDER_EPISODES episodes in ``trace_run``'s Chrome trace: each VCO
    kernel record starts after its ``vco_scan.call`` span starts, and each
    episode's second kernel ends before its ``pi.wait`` span ends.
    Returns the margins (us) and the span clock's offset (ns)."""
    from sspslam_tpu_torch.utils import profiling
    profiling.reset()
    tmp = Path(tempfile.mkdtemp(prefix="spans_"))
    with profiling.trace_run(str(tmp)):
        episodes(fpi, vel, corr, ORDER_EPISODES)
    (path,) = tmp.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    shutil.rmtree(tmp, ignore_errors=True)
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel" and "vco_scan" in e["name"])
    mine = [e for e in events
            if e.get("pid") == profiling.SPAN_ROW and e.get("ph") == "X"]
    calls = sorted(e["ts"] for e in mine if e["name"] == "vco_scan.call")
    waits = sorted(e["ts"] + e["dur"] for e in mine
                   if e["name"] == "pi.wait")
    if not len(kernels) == len(calls) == 2 * len(waits) \
            == 2 * ORDER_EPISODES:
        raise AssertionError(f"Chrome trace: {len(kernels)} kernels, "
                             f"{len(calls)} calls, {len(waits)} waits")
    out = {"launch_after_call_us": [k[0] - c
                                    for k, c in zip(kernels, calls)],
           "wait_after_kernel_us": [w - kernels[2 * j + 1][1]
                                    for j, w in enumerate(waits)],
           "offset_ns": profiling.profiler_clock_offset_ns()}
    log(f"Chrome trace: kernel start - vco_scan.call start (us) "
        f"{out['launch_after_call_us']}; pi.wait end - second kernel end "
        f"(us) {out['wait_after_kernel_us']}; perf_counter_ns + "
        f"{out['offset_ns']} = the profiler's clock")
    if min(out["launch_after_call_us"]) < 0 \
            or min(out["wait_after_kernel_us"]) < 0:
        raise AssertionError("the program's spans and the device records "
                             "are not on one clock")
    return out


def tracing_cost(fpi, vel, corr):
    """COST_PAIRS pairs of COST_EPISODES episodes with tracing off and on
    (``utils.profiling.tracing()``, no profiler), in turns: ms an episode
    on each side and their differences, and the spans' ms an episode with
    no profiler slowing the host (the on sides' spans)."""
    from sspslam_tpu_torch.utils import profiling
    profiling.reset()
    off, on = [], []
    with ClockSampler() as clocks:
        for p in range(COST_PAIRS):
            for traced in ((False, True) if p % 2 == 0 else (True, False)):
                with (profiling.tracing() if traced
                      else contextlib.nullcontext()):
                    t = episodes(fpi, vel, corr, COST_EPISODES)
                (on if traced else off).append(float(np.mean(t)) / 1e6)
    recs = profiling.spans()
    profiling.reset()
    diffs = [b - a for a, b in zip(off, on)]
    n = COST_PAIRS * COST_EPISODES
    out = {"pairs": COST_PAIRS, "episodes": COST_EPISODES,
           "off_ms": off, "on_ms": on, "on_minus_off_ms": diffs,
           "median_off_ms": float(np.median(off)),
           "median_on_ms": float(np.median(on)),
           "median_diff_ms": float(np.median(diffs)),
           "untraced_split_ms": {name: sum(
               r.end_ns - r.start_ns for r in recs if r.name == name)
               / n / 1e6 for name in dict.fromkeys(r.name for r in recs)}}
    out["median_diff_share"] = out["median_diff_ms"] / out["median_off_ms"]
    log(f"tracing cost: ms an episode off {off}, on {on}; median "
        f"difference {out['median_diff_ms']:.4f} ms "
        f"({out['median_diff_share'] * 100:.3f} %); {clocks.summary()}; "
        f"spans with no profiler, ms an episode: "
        f"{out['untraced_split_ms']}")
    return out


def tracing_phase(fpi, space):
    """Phase 36: the program's spans on the benchmark cell's episode (two
    CHUNK-step launches, the velocity and correction tables up, the trace
    down) at the main path's width: the traced split, the Chrome trace's
    order, the cost of tracing."""
    vel, corr = episode_inputs(space, fpi.d)
    episodes(fpi, vel, corr, 2)  # warm-up
    return {"split": traced_split(fpi, vel, corr),
            "order": chrome_trace_order(fpi, vel, corr),
            "cost": tracing_cost(fpi, vel, corr)}


# Phase 37: the SLAM network's LIF ensemble groups (shape of the group's
# state): the OVC ensemble, the memory / error / recall trio, the VCO bank,
# the two convolutions' product arrays
LIF_GROUPS = (("OVC", (970,)), ("memory, error, recall", (3, 970)),
              ("VCO bank", (49, 800)), ("products", (784, 50)))
LIF_STEPS = 50
LIF_SLAM_STEPS = 1_000
LIF_GRAPH_CALLS = 100


def lif_inputs(shape, seed):
    """A LIF group's state and current on the card: J from -1.5 to 3.5 (a
    quarter above 1 fires within a few steps), voltages from -0.3 (below
    ``min_voltage``) to 1.2 (above the threshold), refractory times from
    -1 ms to 3 ms (mid-refractory above dt)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g,
                                           device="cuda")
    return {"voltage": u(-0.3, 1.2), "refractory": u(-0.001, 0.003)}, \
        u(-1.5, 3.5)


def lif_mismatch(what, got, want, inputs):
    """Raise with the first differing neurons of ``got`` against ``want``
    (name -> tensor), their inputs and both values' bits."""
    lines = []
    for name in want:
        bad = torch.nonzero(got[name].view(torch.int32).ne(
            want[name].view(torch.int32)).reshape(-1)).reshape(-1)
        if len(bad):
            lines.append(f"{name}: {len(bad)} of {want[name].numel()} differ")
            for i in bad[:4].tolist():
                ins = {k: float(v.reshape(-1)[i]) for k, v in inputs.items()}
                lines.append(
                    f"  [{i}] inputs {ins}: kernel "
                    f"{float(got[name].reshape(-1)[i])!r} chain "
                    f"{float(want[name].reshape(-1)[i])!r}")
    if lines:
        raise AssertionError(f"{what}: the LIF kernel differs from the ATen "
                             f"chain:\n" + "\n".join(lines))


def lif_bitwise(lif, state, J, what, steps=LIF_STEPS):
    """``steps`` steps of ``lif`` through the kernel and through the
    chain from the same state and current; every output bitwise.  Returns
    the counts of the cases the inputs cover over the run."""
    from sspslam_tpu_torch.ops import lif_step, neurons
    dt = 0.001
    if not lif_step.engages(J, state["voltage"], state["refractory"]):
        raise AssertionError(f"{what}: the kernel does not engage")
    cover = {"J_above_1": int((J > 1).sum()), "J_below_1": int((J <= 1)
                                                               .sum()),
             "below_min_voltage": int((state["voltage"]
                                       < lif.min_voltage).sum()),
             "mid_refractory": 0, "spikes": 0}
    for _ in range(steps):
        cover["mid_refractory"] += int((state["refractory"] > dt).sum())
        v, r, out = lif_step.lif_step(lif, state["voltage"],
                                      state["refractory"], J, dt)
        want, want_out = neurons._lif_step_plain(lif, state, J, dt)
        lif_mismatch(what, {"voltage": v, "refractory": r, "output": out},
                     {"voltage": want["voltage"],
                      "refractory": want["refractory"], "output": want_out},
                     {"J": J, **state})
        cover["spikes"] += int((out > 0).sum())
        state = {"voltage": v, "refractory": r}
    if min(cover.values()) == 0:
        raise AssertionError(f"{what}: the inputs miss a case: {cover}")
    return cover


def graph_us(fn, calls=LIF_GRAPH_CALLS, replays=20):
    """Device time per call of ``fn`` in a CUDA graph of ``calls`` calls,
    by CUDA events over ``replays`` replays (after one)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    ms, _ = cuda_ms(g.replay, replays)
    return ms * 1e3 / calls


def lif_simulator_run(sim, probe, steps):
    """The probe rows and every state leaf of ``steps`` steps from the
    fresh state through the graphs, and the counters of the run."""
    from sspslam_tpu_torch.nef.simulator import _flatten
    from sspslam_tpu_torch.utils import profiling
    sim.reset()
    sim.loop.graphs.clear()
    profiling.reset()
    with profiling.tracing():
        sim.run_steps(steps, segment_steps=steps)
    counts = {k: profiling.counter(k) for k in
              ("lif.fused", "lif.plain", "sim.captures", "sim.steps")}
    profiling.reset()
    return (sim.data[probe], [x.clone() for x in _flatten(sim.state)],
            counts)


def lif_phase(space):
    """Phase 37 (see the module docstring); returns its JSON numbers."""
    from unittest import mock
    from sspslam_tpu_torch.experiments.common import (slam_simulator,
                                                      slam_world)
    from sspslam_tpu_torch.ops import lif_step, neurons
    out = {}
    t0 = time.perf_counter()
    _, nvcc_log = lif_step.build_lif_kernel()
    out["nvcc_s"] = time.perf_counter() - t0 if nvcc_log else None
    log(f"LIF kernel build: {time.perf_counter() - t0:.1f} s"
        + ("" if nvcc_log else " (built already)"))
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    lif = neurons.LIF()
    # tau_rc = 0.03: 1 / tau_rc rounds to another float32 than
    # float32(1) / float32(tau_rc) does (0.02 rounds to 50 either way)
    other = neurons.LIF(tau_rc=0.03, tau_ref=0.0015, amplitude=0.7,
                        min_voltage=-0.1)
    out["groups"] = {}
    for i, (name, shape) in enumerate(LIF_GROUPS):
        state, J = lif_inputs(shape, 37 + i)
        row = {"shape": list(shape),
               "cover": lif_bitwise(lif, state, J, name)}
        lif_bitwise(other, state, J, f"{name}, other constants")
        # rank 1 of 4: the sharded step's rows of a batched group, the
        # neurons of a single one
        per = (shape[0] + 3) // 4
        lo, hi = per, min(shape[0], 2 * per)
        sliced = {k: v[lo:hi] for k, v in state.items()}
        lif_bitwise(lif, sliced, J[lo:hi], f"{name}, rank 1 of 4 [{lo}:{hi}]")
        row["kernel_us"] = graph_us(lambda: lif_step.lif_step(
            lif, state["voltage"], state["refractory"], J, 0.001))
        row["chain_us"] = graph_us(lambda: neurons._lif_step_plain(
            lif, state, J, 0.001))
        log(f"LIF {name} {shape}: kernel bitwise the chain over "
            f"{LIF_STEPS} steps (and rank 1's rows [{lo}:{hi}], other "
            f"constants); cases {row['cover']}; in a graph of "
            f"{LIF_GRAPH_CALLS} calls: kernel {row['kernel_us']:.3f} us, "
            f"chain {row['chain_us']:.3f} us a call")
        out["groups"][name] = row

    world = slam_world()
    sim, probe, build_s = slam_simulator(space, world)
    rows, leaves, counts = lif_simulator_run(sim, probe, LIF_SLAM_STEPS)

    def plain_step(self, state, J, dt):
        return neurons._lif_step_plain(self, state, J, dt)
    with mock.patch.object(neurons.LIF, "step", plain_step):
        want_rows, want_leaves, plain_counts = lif_simulator_run(
            sim, probe, LIF_SLAM_STEPS)
    captured = counts["sim.captures"] * (1 + sim.loop.graph_steps)
    out["slam"] = {"build_s": build_s, "counts": counts,
                   "fused_per_captured_step":
                       counts["lif.fused"] / captured if captured else None,
                   "rows_equal": bool(np.array_equal(rows, want_rows)),
                   "leaves_equal": all(torch.equal(a, b) for a, b in
                                       zip(leaves, want_leaves)),
                   "n_leaves": len(leaves)}
    log(f"LIF on the SLAM Simulator, {LIF_SLAM_STEPS} steps through "
        f"{sim.loop.graph_steps}-step graphs: {out['slam']}; the chain's run "
        f"counted {plain_counts}")
    if not (out["slam"]["rows_equal"] and out["slam"]["leaves_equal"]
            and out["slam"]["fused_per_captured_step"] == 4
            and counts["lif.plain"] == 0 and np.isfinite(rows).all()):
        raise AssertionError(f"LIF on the SLAM Simulator: {out['slam']}")
    del sim
    return out


def time_checkout(root: str) -> None:
    """``--time ROOT``: ms per CHUNK-step chunk of the ``vco_scan`` of the
    checkout at ``root``, at the cluster size it picks, on the main path's
    first chunk (zero state, no corrections), by CUDA events: one warm-up
    launch, then TIME_REPEATS.  Prints one JSON line."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    from sspslam_tpu_torch import FastPathIntegrator, HexagonalSSPSpace
    from sspslam_tpu_torch.ops import vco_scan as vco
    torch.backends.cuda.matmul.allow_tf32 = False
    fpi = FastPathIntegrator(make_space(HexagonalSSPSpace), N_NEURONS,
                             seed=SEED, chunk_steps=CHUNK, device="cuda")
    vel = torch.tensor(traffic()[:CHUNK], device="cuda")
    corr = torch.zeros((CHUNK, fpi.d), dtype=torch.float32, device="cuda")
    state0 = fpi.initial_state()

    def launch():
        return vco.vco_scan(fpi.params, state0, vel, corr)
    launch()  # build, load, warm up
    ms, _ = cuda_ms(launch, TIME_REPEATS)
    print(json.dumps({"root": root, "nvidia_smi": nvidia_smi(),
                      "neurons": fpi.n, "k": fpi.k, "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Smoke test of the PyTorch / CUDA port on one GPU.")
    ap.add_argument("--time", metavar="ROOT",
                    help="only time the VCO-bank kernel of the checkout at "
                         "ROOT (see the module docstring)")
    ap.add_argument("--tracing", action="store_true",
                    help="only run phase 36, the program's spans")
    ap.add_argument("--lif", action="store_true",
                    help="only run phase 37, the LIF kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.time is not None:
        time_checkout(args.time)
        return 0
    from sspslam_tpu_torch import FastPathIntegrator, HexagonalSSPSpace
    from sspslam_tpu_torch.ops import vco_scan as vco
    if args.tracing:
        torch.backends.cuda.matmul.allow_tf32 = False
        space = make_space(HexagonalSSPSpace)
        fpi = FastPathIntegrator(space, N_NEURONS, seed=SEED,
                                 chunk_steps=CHUNK, device="cuda")
        log(f"torch {torch.__version__}, {nvidia_smi()}")
        print(json.dumps({"tracing": tracing_phase(fpi, space)}),
              flush=True)
        print(nvidia_smi(), flush=True)
        return 0
    if args.lif:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
            f"{nvidia_smi()}")
        print(json.dumps({"lif": lif_phase(make_space(HexagonalSSPSpace))}),
              flush=True)
        print(nvidia_smi(), flush=True)
        return 0

    # 1. device
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), {card}, "
        f"{num_sms} SMs; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    _, nvcc_log = vco.build_vco_kernel()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain version, on the main path's own build
    space = make_space(HexagonalSSPSpace)
    t0 = time.perf_counter()
    fpi = FastPathIntegrator(space, N_NEURONS, seed=SEED, chunk_steps=CHUNK,
                             device="cuda")
    log(f"FastPathIntegrator build (d={fpi.d}, k={fpi.k}, n={fpi.n}): "
        f"{time.perf_counter() - t0:.1f} s")
    chosen = vco._cluster_size(fpi.n, fpi.k, num_sms)
    log(f"cluster size the wrapper picks for n={fpi.n}, k={fpi.k}: {chosen}")
    err, plain_ms, spikes, y_chunk, first_plain = check_kernel(fpi, space,
                                                               vco)
    check_other_widths(vco, HexagonalSSPSpace, FastPathIntegrator)

    # 4. cluster sweep
    swept = cluster_sweep(vco, fpi, HexagonalSSPSpace, FastPathIntegrator,
                          num_sms)
    full = swept["full width"]

    # 5. main path
    fpi.state = fpi.initial_state()
    launches, trace = main_path(fpi, vco, space, y_chunk[chosen],
                                first_plain)

    # 6. whole run against the other cluster size
    other, ends = whole_run(vco, fpi, space, chosen, trace)

    # 34, fast path: the same run against JAX's Pallas kernel
    ref = load_reference()
    reference = {"fast_path": reference_fast(ref, fpi, space, trace)}

    # 7. accuracy
    accuracy(HexagonalSSPSpace, FastPathIntegrator)

    # 31. the sharded scan, on the card while it is quiet
    sharded = sharded_scan(vco, fpi, space, y_chunk[chosen],
                           float(np.mean(full[chosen])), num_sms)

    # 36. the program's spans on the fast path
    tracing = tracing_phase(fpi, space)

    # 8-10. the generic engine
    simulator = simulator_path(space, vco, trace)
    simulator["semantics_vs_cpu"] = simulator_semantics()
    simulator["accuracy_error"] = simulator_accuracy(HexagonalSSPSpace)

    # 11-12. SLAM
    slam = slam_path(space, vco)

    # 37. the LIF kernel
    lif = lif_phase(space)

    # 33. the port's benchmark and its probes, on the quiet card
    bench = bench_phase(vco, slam)

    # 14-17. the rest of the model family
    family = family_models(space, vco)
    family["cleanup"] = cleanup_methods(vco)
    family["pi_variants"] = pi_variants(space, vco)

    # 10, 13, 18 (and 23's, 25's, 26's children) and 28-30's CLIs: run
    # together beside 28-30's in-process checks; ``work`` holds the npz
    # files the CLIs of phases 21 and 28 write for 28 and 30 to read
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    children, (schedule, maps, flagship, demos, reference["slam"]) = \
        children_and_checks(vco, work, ref)
    mesh = mesh_phase(children["mesh"])
    simulator["run_pathint"] = cli_errors("run_pathint",
                                          *children["run_pathint"])
    slam["run_slam"] = cli_errors("run_slam", *children["run_slam"])
    family["run_slamview"] = cli_errors("run_slamview",
                                        *children["run_slamview"])
    family["run_slam_gated"] = cli_errors("run_slam --backend gated",
                                          *children["run_slam_gated"])

    # 19-21. quantised storage, batched episodes, the scaled CLI
    scaled = {"quantised": quantised_slam(space, vco, slam),
              "batched": batched_episodes(space, vco),
              "scaled_slam": scaled_slam(work)}

    # 22-24. training through episodes, closed-loop sessions
    training = {"pathint": train_pathint_phase(vco),
                "slam": train_slam_phase(vco, children),
                "closed_loop": closed_loop_phase(space, vco)}

    # 25-27. the serving bundle, the interpreter, the host library
    serving = {"bundle": serving_phase(space, vco, children, slam)}
    serving["interpreter"], isim = interpreter_phase(
        space, vco, children, serving["bundle"]["live_steps_per_s"])
    serving["host"] = host_phase(isim, vco)
    del isim

    # 28-30. the SLAM experiment CLIs (run with the untimed children)
    clis = {"loop_closure": loop_closure_phase(children, schedule, work),
            "maps": maps_phase(children, maps),
            "analyses": analyses_phase(children, flagship, work)}
    shutil.rmtree(work, ignore_errors=True)

    ms = float(np.mean(full[chosen]))
    b_ms, b_by = bound_ms(fpi.n, fpi.k, fpi.d, fpi.N, CHUNK, spikes)
    log(f"bound per {CHUNK}-step chunk ({spikes} spikes): {b_ms:.4f} ms "
        f"({b_by}); kernel {ms:.3f} ms = {b_ms / ms * 100:.2f} % of its "
        f"bound")
    print(json.dumps({"simulator": simulator}), flush=True)
    print(json.dumps({"slam": slam}), flush=True)
    print(json.dumps({"lif": lif}), flush=True)
    print(json.dumps({"family": family}), flush=True)
    print(json.dumps({"scaled": scaled}), flush=True)
    print(json.dumps({"train": training}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"clis": clis}), flush=True)
    print(json.dumps({"sharded": sharded, "demos": demos}), flush=True)
    print(json.dumps({"bench": bench}), flush=True)
    print(json.dumps({"reference": reference}), flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
    print(json.dumps({"tracing": tracing}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "vco_scan", "route": "cuda",
        "source": "sspslam_tpu_torch/csrc/vco_scan.cu",
        "replaces": "sspslam_tpu/ops/pallas_kernels.py:247",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "cluster": chosen, "spikes": spikes,
        "ms_by_cluster": {str(C): t for C, t in full.items()},
        "floor_ms_by_cluster": {
            str(C): t for C, t in swept["floor"].items()},
        "sweep_ms_by_cluster": {
            width: {str(C): t for C, t in times.items()}
            for width, times in swept.items()},
        "whole_run_vs_cluster": other,
        "whole_run_decoded_diff": ends,
        "whole_run_vs_jax_pallas": reference["fast_path"],
        "launched_by": ["FastPathIntegrator.run (phase 5, bench.py --model "
                        "pi-fast traffic)",
                        "make_sharded_vco_scan (phase 31): one launch per "
                        "shard per chunk",
                        "make_sharded_vco_scan(mesh=...) (phase 35): one "
                        "launch per rank per chunk, on each rank's card",
                        "python -m sspslam_tpu_torch.bench --model pi-fast "
                        "(phase 33)"],
        "launches_on_bench_pi_fast": bench["pi_fast"]["vco_scan_launches"],
        "launches_on_sharded_path": {
            S: r["launches_per_chunk"] for S, r in sharded.items()},
        "sharded_ms_by_shards": {S: r["ms"] for S, r in sharded.items()},
        "launches_on_mesh_path": {
            "world": mesh["runs"][0]["world"],
            "per_rank_per_chunk":
                mesh["runs"][0]["vco_launches_per_rank_per_chunk"]},
        "launches_on_simulator_paths": {
            "pi (phase 8)": simulator["vco_scan_launches"],
            "run_pathint (phase 10)":
                simulator["run_pathint"]["vco_scan_launches"],
            "slam (phases 11-12)": slam["vco_scan_launches"],
            "run_slam (phase 13)": slam["run_slam"]["vco_scan_launches"],
            "slam_gated (phase 14)": family["gated"]["vco_scan_launches"],
            "slam_view (phase 15)": family["view"]["vco_scan_launches"],
            "cleanup methods (phase 16)":
                family["cleanup"]["vco_scan_launches"],
            "pi variants (phase 17)":
                family["pi_variants"]["vco_scan_launches"],
            "run_slamview (phase 18)":
                family["run_slamview"]["vco_scan_launches"],
            "run_slam --backend gated (phase 18)":
                family["run_slam_gated"]["vco_scan_launches"],
            "training episodes (phase 22)":
                training["pathint"]["vco_scan_launches"],
            "train_pathint (phase 22)":
                training["pathint"]["train_pathint"]["vco_scan_launches"],
            "train_slam (phase 23)":
                training["slam"]["train_slam"]["vco_scan_launches"],
            "tune_loop_closure (phase 23)":
                training["slam"]["tune_loop_closure"]["vco_scan_launches"],
            "tune_loop_closure in place (phase 23)":
                training["slam"]["tune_in_place"]["vco_scan_launches"],
            "train_slam, tiny width (phase 23)":
                training["slam"]["meta_gradient_card_vs_cpu"][
                    "vco_scan_launches"],
            "closed-loop session (phase 24)":
                training["closed_loop"]["vco_scan_launches"],
            "closed_loop_nav (phase 24)":
                training["closed_loop"]["closed_loop_nav"][
                    "vco_scan_launches"],
            "serving bundle (phase 25)":
                serving["bundle"]["vco_scan_launches"],
            "serving_probe (phase 25)":
                serving["bundle"]["serving_probe"]["vco_scan_launches"],
            "interpreter (phase 26)":
                serving["interpreter"]["vco_scan_launches"],
            "run_slam --backend numpy (phase 26)":
                serving["interpreter"]["run_slam_numpy"][
                    "vco_scan_launches"],
            "host library and trace_run (phase 27)":
                serving["host"]["vco_scan_launches"],
            "validate_loop_closure --tuned (phase 28)":
                clis["loop_closure"]["headline"]["vco_scan_launches"],
            "kidnapped_robot --in-model (phase 28)":
                clis["loop_closure"]["kidnap_in_model"]["vco_scan_launches"],
            "kidnapped_robot --dump (phase 28)":
                clis["loop_closure"]["kidnap_scripted"]["vco_scan_launches"],
            "check_anchor_enters (phase 28)":
                clis["loop_closure"]["kidnap_scripted"][
                    "check_anchor_enters_vco_scan_launches"],
            "recovery schedule in process (phase 28)":
                clis["loop_closure"]["schedule"]["vco_scan_launches"],
            "map_merge (phase 29)":
                clis["maps"]["map_merge"]["vco_scan_launches"],
            "live_merge (phase 29)":
                clis["maps"]["live_merge"]["vco_scan_launches"],
            "merge and exchange in process (phase 29)":
                clis["maps"]["in_process"]["vco_scan_launches"],
            "gate_fidelity (phase 30)":
                clis["analyses"]["gate_fidelity"]["vco_scan_launches"],
            "bf16_drift (phase 30)":
                clis["analyses"]["bf16_drift"]["vco_scan_launches"],
            "scale_study (phase 30)":
                clis["analyses"]["scale_study"]["vco_scan_launches"],
            "model summary in process (phase 30)":
                clis["analyses"]["scale_study"][
                    "summary_vco_scan_launches"],
            "redecode_scaled (phase 30)":
                clis["analyses"]["redecode_scaled"][
                    "vco_scan_launches"],
            "run_pathint_gif, run_slam_map_gif, slam_map_new (phase 32)":
                demos["vco_scan_launches"],
            "bench --model slam (phase 33)":
                bench["slam"]["vco_scan_launches"],
            "step_roofline (phase 33)": bench["vco_scan_launches"]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
