"""The VCO path integrator with its oscillator axis split into shards.

Port of :mod:`sspslam_tpu.parallel.shard_step`.  The JAX module lays the
(d+1)//2 oscillators over a device mesh with ``shard_map``: each device
scans its own oscillators and one ``psum`` per step adds the partial (1, d)
SSPs.  Here each shard is a contiguous slice of the oscillators, and its
chunk is one call of :func:`ops.vco_scan.vco_scan`: on a CUDA tensor the
Hopper kernel (``csrc/vco_scan.cu``), on a CPU tensor the plain version.
Without a mesh every shard runs on one card, each on a CUDA stream of its
own; with a mesh (:mod:`.sharding`) rank s of the model axis runs shard s
on its own device, one launch a chunk.  The kernel returns the FILTERED
decode rows projected to the SSP, and filtering commutes with that
projection, so the sum of the shards' (T, d) traces is the JAX ``psum``
result: one all-reduce a chunk, none a step.  Only the order of a sum
differs from the unsharded scan.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.vco_scan import (ARRAY_FIELDS, VCOParams, VCOState,
                            initial_vco_state, vco_scan)

__all__ = ["pad_vco_params", "make_sharded_vco_scan"]

F32 = torch.float32
#: fields whose oscillator axis is 0 ((k, d) reassembly matrices); the
#: rest are (rows, k)
_K_ROWS = ("ts0T", "ts1T")


def pad_vco_params(params: VCOParams, n_shards: int) -> VCOParams:
    """Pad the oscillator axis k to a multiple of ``n_shards`` (padded
    oscillators have zero encoders, decoders and bias, so they stay
    silent)."""
    k = params.bias.shape[1]
    k_pad = ((k + n_shards - 1) // n_shards) * n_shards
    if k_pad == k:
        return params
    rep = {}
    for name in ARRAY_FIELDS:
        x = getattr(params, name)
        axis = 0 if name in _K_ROWS else 1
        shape = list(x.shape)
        shape[axis] = k_pad - k
        rep[name] = torch.cat([x, x.new_zeros(shape)], dim=axis)
    return params._replace(**rep)


def _shard(params: VCOParams, lo: int, hi: int) -> VCOParams:
    """Oscillators lo..hi-1 as contiguous float32 copies (the kernel takes
    no strided slice)."""
    return params._replace(**{
        name: (getattr(params, name)[lo:hi] if name in _K_ROWS
               else getattr(params, name)[:, lo:hi]).to(F32).contiguous()
        for name in ARRAY_FIELDS})


def make_sharded_vco_scan(params: VCOParams, n_shards, n_steps: int,
                          *, device="cuda", mesh=None, axis: str = "model"):
    """Build ``fn(state, vel_chunk, corr_chunk) -> (state, ssp_chunk)``
    over ``n_steps`` steps with the oscillator axis split into
    ``n_shards`` contiguous shards (k padded to a multiple first).

    ``state`` is a list of per-shard :class:`VCOState`\\ s, from
    ``fn.initial_state()`` or a previous call; vel_chunk (n_steps, N) and
    corr_chunk (n_steps, d) are tensors or arrays; ssp_chunk is the
    filtered (n_steps, d) SSP trace on ``device``, the shards' traces
    summed in shard order.  ``fn.padded_params`` is the padded bank and
    ``fn.shards`` the shards' banks.  On a CUDA device each shard's kernel
    runs on its own stream and the sum waits for all of them.

    ``mesh``: the shards are the ranks of its ``axis`` (``n_shards`` None
    or that size) and ``device`` is the mesh's.  Each rank holds and runs
    its own shard only: ``state`` is the one-element list of its
    :class:`VCOState`, and ssp_chunk is the all-reduced sum, the same on
    every rank."""
    if mesh is not None:
        if n_shards not in (None, mesh.shape[axis]):
            raise ValueError(f"make_sharded_vco_scan: {n_shards} shards "
                             f"over a mesh axis of {mesh.shape[axis]}")
        return _mesh_scan(params, n_steps, mesh, axis)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_sharded_vco_scan: device='cuda' but no "
                           "CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"make_sharded_vco_scan: no path for {device}")
    padded = pad_vco_params(params, n_shards)
    n, k = padded.bias.shape
    k_shard = k // n_shards
    shards = [_shard(_on(padded, device), s * k_shard, (s + 1) * k_shard)
              for s in range(n_shards)]
    streams = ([torch.cuda.Stream(device) for _ in shards]
               if device.type == "cuda" else None)

    def run(state: List[VCOState], vel_chunk, corr_chunk
            ) -> Tuple[List[VCOState], torch.Tensor]:
        vel = torch.as_tensor(vel_chunk, dtype=F32, device=device)
        corr = torch.as_tensor(corr_chunk, dtype=F32, device=device)
        vel, corr = vel.contiguous(), corr.contiguous()
        if vel.shape[0] != n_steps or corr.shape[0] != n_steps:
            raise ValueError(f"sharded vco_scan: chunks of {n_steps} steps "
                             f"(got {vel.shape[0]} and {corr.shape[0]})")
        if len(state) != n_shards:
            raise ValueError(f"sharded vco_scan: {n_shards} shard states "
                             f"(got {len(state)})")
        if streams is None:
            outs = [vco_scan(p, s, vel, corr) for p, s in zip(shards, state)]
        else:
            outs = _on_streams(shards, state, vel, corr, streams, device)
        total = outs[0][1]
        for _, y in outs[1:]:
            total = total + y
        return [new for new, _ in outs], total

    def initial_state() -> List[VCOState]:
        return [initial_vco_state(n, k_shard, device=device)
                for _ in range(n_shards)]

    run.initial_state = initial_state
    run.padded_params = padded
    run.shards = shards
    return run


def _mesh_scan(params: VCOParams, n_steps: int, mesh, axis: str):
    """make_sharded_vco_scan over the ranks of ``mesh``'s ``axis``."""
    import torch.distributed as dist
    device = mesh.device
    n_shards, rank = mesh.shape[axis], mesh.coord(axis)
    group = mesh.group(axis)
    padded = pad_vco_params(params, n_shards)
    n, k = padded.bias.shape
    k_shard = k // n_shards
    mine = _shard(_on(padded, device), rank * k_shard, (rank + 1) * k_shard)

    def run(state: List[VCOState], vel_chunk, corr_chunk
            ) -> Tuple[List[VCOState], torch.Tensor]:
        vel = torch.as_tensor(vel_chunk, dtype=F32, device=device)
        corr = torch.as_tensor(corr_chunk, dtype=F32, device=device)
        vel, corr = vel.contiguous(), corr.contiguous()
        if vel.shape[0] != n_steps or corr.shape[0] != n_steps:
            raise ValueError(f"sharded vco_scan: chunks of {n_steps} steps "
                             f"(got {vel.shape[0]} and {corr.shape[0]})")
        if len(state) != 1:
            raise ValueError("sharded vco_scan: a rank holds one shard "
                             f"state (got {len(state)})")
        new, y = vco_scan(mine, state[0], vel, corr)
        y = y.contiguous()
        dist.all_reduce(y, group=group)     # the chunk's one collective
        return [new], y

    def initial_state() -> List[VCOState]:
        return [initial_vco_state(n, k_shard, device=device)]

    run.initial_state = initial_state
    run.padded_params = padded
    run.shards = [mine]
    return run


def _on_streams(shards, state, vel, corr, streams, device):
    """Each shard's ``vco_scan`` launched on its own stream after the
    current stream's work; the current stream then waits for all of
    them."""
    main = torch.cuda.current_stream(device)
    outs = []
    for p, s, stream in zip(shards, state, streams):
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            outs.append(vco_scan(p, s, vel, corr))
        # made on ``main`` and read on ``stream``: their memory is not
        # reused before ``stream`` is done with it
        for x in (vel, corr, *s):
            x.record_stream(stream)
    for stream, (new, y) in zip(streams, outs):
        main.wait_stream(stream)
        # made on ``stream``, read and freed on ``main``
        for x in (y, *new):
            x.record_stream(main)
    return outs


def _on(params: VCOParams, device) -> VCOParams:
    return params._replace(**{name: getattr(params, name).to(device)
                              for name in ARRAY_FIELDS})
