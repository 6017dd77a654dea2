"""A built model's resource summary (neurons, weight and state memory and
the multiply-adds of one step, per ensemble group) and a trace context.

Port of :mod:`sspslam_tpu.utils.profiling`: ``model_utilization_summary``
and ``print_utilization_summary`` (the counterpart of the reference's
Loihi utilization printout; host-only arithmetic on the built shapes, with
no counterpart of the JAX module's TPU on-chip-memory share) and
``trace_run``, a ``torch.profiler`` context in place of the JAX module's
``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch

__all__ = ["model_utilization_summary", "print_utilization_summary",
           "trace_run"]


def _size(x) -> int:
    return int(x.numel()) if torch.is_tensor(x) else int(np.size(x))


def model_utilization_summary(model) -> List[dict]:
    """Per-ensemble-group resource rows for a built Model."""
    rows = []
    conn_by_pre = {}
    for bc in model.connections:
        if bc.decoders is not None:
            conn_by_pre.setdefault(id(bc.pre), []).append(bc)

    for be in model.ensembles:
        n_neurons = be.k * be.n if be.batched else be.n
        enc_elems = _size(be.scaled_encoders)
        dec_elems = sum(_size(bc.decoders)
                        for bc in conn_by_pre.get(id(be), []))
        # J matvec + decode matvecs, 2 flops per MAC
        flops = 2 * (enc_elems + dec_elems)
        state_bytes = sum(
            _size(v) * 4 for v in be.neuron_type.init_state(
                (be.k, be.n) if be.batched else (be.n,)).values())
        rows.append({
            "label": getattr(be.obj, "label", None) or f"ens{be.index}",
            "batched": be.batched,
            "neurons": int(n_neurons),
            "encoder_bytes": enc_elems * 4,
            "decoder_bytes": dec_elems * 4,
            "state_bytes": int(state_bytes),
            "flops_per_step": int(flops),
        })
    return rows


def print_utilization_summary(model, file=None):
    rows = model_utilization_summary(model)
    total_neurons = sum(r["neurons"] for r in rows)
    total_bytes = sum(r["encoder_bytes"] + r["decoder_bytes"]
                      + r["state_bytes"] for r in rows)
    total_flops = sum(r["flops_per_step"] for r in rows)
    print(f"model resources: {len(rows)} ensemble groups, "
          f"{total_neurons} neurons, "
          f"{total_bytes / 2**20:.1f} MiB weights+state, "
          f"~{total_flops / 1e6:.2f} MFLOP/step", file=file)
    for r in sorted(rows, key=lambda r: -r["flops_per_step"])[:8]:
        kib = (r["encoder_bytes"] + r["decoder_bytes"]) / 2**10
        print(f"  {r['label']:<24} {r['neurons']:>7} neurons  "
              f"{kib:>8.0f} KiB  "
              f"{r['flops_per_step'] / 1e3:>8.0f} kFLOP/step", file=file)
    return rows


@contextlib.contextmanager
def trace_run(logdir: str):
    """``torch.profiler`` trace context: ``with trace_run('/tmp/trace'):
    sim.run(...)`` writes a Chrome trace (``<host>.<pid>.<ms>.pt.trace.json``)
    into ``logdir``, for Perfetto, ``chrome://tracing`` or TensorBoard.
    Traces the host and, where there is one, the CUDA device; yields the
    profiler (``key_averages()`` sums the events by name)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
