"""The reference side of the fast-path cell.

The reference builds its own VCO bank from the configuration and the seed
(:mod:`.vco`), with its own SSP space, velocity scale and clamp rows
(:mod:`.ssp`), and judges one episode of the program's window by four
numbers:

- ``table_gap``: the program's encoders, biases and fixed projections
  against the reference's, the worst table's ||p - r|| / ||r||;
- ``decode_gap``: the program's recurrent and output decoders by what
  they decode, ||A (D_p - D_r)|| / ||A D_r|| with A the reference's rates
  at its evaluation points, the worse connection;
- ``start_gap``: the episode's first K trace rows against the reference's
  scan from rest, oscillator by oscillator (:func:`.check.oscillator_gap`);
- ``chunk_gap``: at each boundary between two launches, the K rows after
  it against the reference's scan of K steps from the state the program
  carried across, the same way.

A spiking run parts from any other computation of itself within a few
hundred steps (one spike at another step), so the episode's middle is not
compared row by row: the reference follows the program's state from each
boundary instead, and the start from rest.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import core
from benchmark.harness import world as W

from . import check, ssp, vco

NAMES = ("table_gap", "decode_gap", "start_gap", "chunk_gap")


def inputs(cfg, mix, seed, path_index, phase):
    """The episode's velocity rows (at the reference's own scale, from
    the run's first path) and clamp rows, encoded by the reference."""
    _, vel0 = W.pi_episode(mix, seed, 0)
    scale = float(1.0 / np.max(np.abs(phase @ vel0.T)))
    path, vels = W.pi_episode(mix, seed, path_index)
    clamp = int(round(cfg["clamp_s"] / cfg["dt"])) - 1
    corr = np.zeros((vels.shape[0], cfg["ssp_dim"]))
    corr[:clamp] = ssp.encode(phase, cfg["length_scale"], path[:clamp])
    return vels * scale, corr, scale


def build(cfg, mix, seed, path_index, device, tf32=False):
    """(tables, velocity rows, clamp rows) of the reference."""
    phase = ssp.phase_matrix(cfg["domain_dim"], cfg["ssp_dim"])
    vel, corr, scale = inputs(cfg, mix, seed, path_index, phase)
    tables = vco.bank(cfg, W.model_seed(seed), scale, device, tf32=tf32)
    return tables, vel, corr


def scan(cfg, tables, vel, corr, device, state=None):
    return vco.scan(tables, vel, corr, recurrent_tau=cfg["recurrent_tau"],
                    tau_probe=cfg["probe_synapse"], dt=cfg["dt"],
                    state=state, device=device)


def decode_gap(prog: dict, ref: dict) -> float:
    A = ref["A"]
    gaps = {}
    for conn, names in vco.DECODERS.items():
        def stack(t):
            return torch.stack([torch.as_tensor(check.host(t[m]),
                                                device=A.device).T
                                for m in names], dim=-1)    # (k, n, c)
        want = A @ stack(ref)
        got = A @ stack(prog)
        gaps[conn] = check.rel_gap(got, want)
    return check.worst(gaps)


def gaps(cfg, out, ref, vel, corr, y_ref, K, device):
    """The four numbers of ``out`` (the program's episode, or the
    control's in its place) against the reference, and where each is
    worst."""
    table = check.worst({m: check.rel_gap(out["tables"][m], ref[m])
                         for m in vco.TABLES})
    decode = decode_gap(out["tables"], ref)
    y = np.asarray(out["trace"], np.float64)
    start = check.oscillator_gap(y[:K], y_ref[:K])
    chunk, at = 0.0, None
    T = out["chunk"]
    for c, s0 in enumerate(out["states"], start=1):
        b = c * T
        yb, _, _ = scan(cfg, ref, vel[b:b + K], corr[b:b + K], device,
                        state=s0)
        g = check.oscillator_gap(y[b:b + K], yb)
        if not g <= chunk:
            chunk, at = g, b
    if not out["states"] and y.shape[0] > T:
        chunk, at = float("inf"), "no state carried across a boundary"
    return ({"table_gap": table[0], "decode_gap": decode[0],
             "start_gap": start, "chunk_gap": chunk},
            {"table_gap": table[1], "decode_gap": decode[1],
             "chunk_gap": at})


def control_outputs(cfg, mix, seed, path_index, T, K, device):
    """The control in the program's place: the reference's bank and scan
    with every contraction's operands rounded to TF32, run chunk by chunk
    as the program runs an episode."""
    tables, vel, corr = build(cfg, mix, seed, path_index, device,
                              tf32=True)
    rows, states, state = [], [], None
    for a in range(0, vel.shape[0], T):
        y, _, state = scan(cfg, tables, vel[a:a + T], corr[a:a + T],
                           device, state=state)
        rows.append(y)
        if a + T < vel.shape[0]:
            states.append({k: v.clone() for k, v in state.items()})
    return {"tables": {m: tables[m] for m in vco.TABLES
                       + sum(vco.DECODERS.values(), ())},
            "trace": np.concatenate(rows), "states": states, "chunk": T}


def readings(cfg, mix, seed, device, out) -> dict:
    """The compared numbers of the program's episode and of the control's
    (for setting the limits)."""
    K = mix["check_rows"]
    ref, vel, corr = build(cfg, mix, seed, out["path"], device)
    y_ref, _, _ = scan(cfg, ref, vel[:K], corr[:K], device)
    control = control_outputs(cfg, mix, seed, out["path"], out["chunk"], K,
                              device)
    return {"program": gaps(cfg, out, ref, vel, corr, y_ref, K, device),
            "control": gaps(cfg, control, ref, vel, corr, y_ref, K,
                            device)}


def check_episode(ctx, out) -> None:
    cfg, mix = ctx.cfg, ctx.mix
    K = mix["check_rows"]
    t0 = time.perf_counter()
    ref, vel, corr = build(cfg, mix, ctx.seed, out["path"], ctx.device)
    t1 = time.perf_counter()
    # the whole episode from rest: its first rows, and its spikes for the
    # chunk's operation count
    y_ref, spikes, _ = scan(cfg, ref, vel, corr, ctx.device)
    t2 = time.perf_counter()
    n, k = ref["bias"].shape
    T = out["chunk"]
    per_chunk = [int(spikes[a:a + T].sum())
                 for a in range(0, len(spikes), T)]
    ctx.counts.update(n=n, k=k, d=cfg["ssp_dim"], N=cfg["domain_dim"], T=T,
                      chunk_spikes=per_chunk, episode_steps=len(spikes))
    g, where = gaps(cfg, out, ref, vel, corr, y_ref, K, ctx.device)
    core.log(f"reference: build {t1 - t0:.1f} s, episode {out['episode']} "
             f"(path {out['path']}) scan {t2 - t1:.1f} s, spikes per chunk "
             f"{per_chunk}; worst: {where}")
    for name in NAMES:
        ctx.checks.append((name, float(g[name]),
                           float(mix["limits"][name])))
