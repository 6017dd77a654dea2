"""Batched episodes of one built model (the data-parallel axis).

Port of :mod:`sspslam_tpu.parallel.trials`.  B episodes of the same built
model, each with its own input stream and its own state (neurons, filters,
learned PES / Voja weights, node states), advance together: the executor's
step runs under ``torch.func.vmap`` over the leading episode axis of the
state and the inputs, with the parameters shared, through the Simulator's
step loop (:class:`..nef.steploop.StepLoop`): on the card U batched steps
are captured as one CUDA graph and replayed, and the time-major input
table (T, B, size) is uploaded once.  A failed vmap or capture raises;
nothing falls back to a loop over episodes.

With a mesh (:mod:`.sharding`), the episodes are split over its data
axis: each rank runs its contiguous share of them, and the probe traces
are gathered, in episode order, on every rank.  If the mesh also has a
model axis (dp x tp), each episode runs the model-sharded step of its
model group, one episode after another (its collectives have no batching
rule, so they are not vmapped).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..nef.simulator import Simulator
from ..nef.steploop import GRAPH_STEPS, StepLoop, to_host

__all__ = ["BatchedEpisodes", "run_batched_episodes", "run_seed_sweep"]


class BatchedEpisodes:
    """B episodes of ``sim``'s model stepped together on ``sim.device``.

    ``tables``: one time-major (T, B, size) array or tensor per tabulated
    input node, in ``sim.model.input_nodes`` order; steps past row T - 1
    read the last row.  Every episode starts from ``sim``'s current state;
    ``sim`` itself is not changed.  ``collect=False`` writes no probe
    buffers (throughput runs).  ``graph_steps`` is the steps per captured
    CUDA graph; ``loop.eager = True`` steps eagerly on the card too."""

    def __init__(self, sim: Simulator, tables, *,
                 graph_steps: int = GRAPH_STEPS, collect: bool = True):
        model = sim.model
        if len(tables) != len(model.input_nodes):
            raise ValueError(f"expected {len(model.input_nodes)} input "
                             f"tables, got {len(tables)}")
        self.device = sim.device
        table, splits = None, []
        B = 1
        if tables:
            cols = [torch.as_tensor(t).to(self.device, torch.float32)
                    for t in tables]
            B = cols[0].shape[1]
            if any(c.ndim != 3 or c.shape[:2] != cols[0].shape[:2]
                   for c in cols):
                raise ValueError("input tables must share (T, B): "
                                 f"{[tuple(c.shape) for c in cols]}")
            table = torch.cat(cols, 2).contiguous()
            offs = np.cumsum([0] + [c.shape[2] for c in cols]).tolist()
            splits = list(zip(offs[:-1], offs[1:]))
        self.B = B
        self.state = pytree.tree_map(
            lambda x: x.expand((B,) + tuple(x.shape)).clone(), sim.state)
        vstep = torch.func.vmap(sim._step_fn, in_dims=(0, 0, None))

        def step(state, x, params):
            xs = [] if x is None else [x[:, a:b] for a, b in splits]
            return vstep(state, xs, params)
        dense = [bp for bp in model.probes if not bp.sparse] if collect else []
        self.loop = StepLoop(self.device, step, self.state, sim.params,
                             {bp.index: (B,) + tuple(bp.shape)
                              for bp in dense}, graph_steps=graph_steps)
        self.loop.use_table(table)
        self.n_steps = 0

    def run(self, steps: int) -> Optional[Dict[int, torch.Tensor]]:
        """Advance every episode ``steps`` steps, reading table rows from
        where the last call stopped.  Returns {probe index: (steps, B, ...)}
        views of the device buffers (valid until the next call), or None
        when nothing is collected."""
        self.loop.run(steps, row=self.n_steps)
        self.n_steps += steps
        if not self.loop.bufs:
            return None
        return {k: v[:steps] for k, v in self.loop.bufs.items()}

    def sync(self) -> int:
        """Wait for the queued steps; returns the steps run."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.n_steps


def run_batched_episodes(sim: Simulator, input_tables: List, n_steps: int,
                         graph_steps: int = GRAPH_STEPS, *,
                         mesh=None, axis: str = "data",
                         model_axis: str = "model"):
    """Run B episodes of ``sim``'s model in parallel.

    sim : a built Simulator (its current state is every episode's start).
    input_tables : one (B, n_steps, size) array per tabulated input node, in
        ``sim.model.input_nodes`` order; uploaded once, time-major.
    mesh : a :class:`.sharding.Mesh` with an ``axis`` axis: B (a multiple
        of its size) is split over it.  If it also has a ``model_axis``,
        each episode's state and the parameters are
        split over that axis too (a Simulator built with ``mesh`` holds
        them so already; an unsharded one is sliced here).

    Returns ({probe object: (B, n_steps, ...) array} for dense probes, the
    final state tree with a leading episode axis on the device), and
    leaves ``sim`` untouched.  Under a mesh the traces are every
    episode's, on every rank; the final state is this rank's episodes'
    (and under a model axis, this rank's slices)."""
    if mesh is None:
        return _run_local(sim, input_tables, n_steps, graph_steps)
    import torch.distributed as dist
    B = int(np.shape(input_tables[0])[0]) if input_tables else 1
    nd = mesh.shape[axis]
    if B % nd:
        raise ValueError(f"run_batched_episodes: {B} episodes over a data "
                         f"axis of {nd}")
    lo = mesh.coord(axis) * (B // nd)
    mine = [np.asarray(t)[lo:lo + B // nd] for t in input_tables]
    if model_axis in mesh.shape:
        out, state = _run_model_sharded(sim, mine, n_steps, mesh,
                                        model_axis)
    else:
        out, state = _run_local(sim, mine, n_steps, graph_steps)
    group = mesh.group(axis)
    whole = {}
    for obj, v in out.items():
        t = torch.as_tensor(np.ascontiguousarray(v)).to(sim.device)
        parts = [torch.empty_like(t) for _ in range(nd)]
        dist.all_gather(parts, t, group=group)
        whole[obj] = to_host(torch.cat(parts))
    return whole, state


def _dense_out(model, traces):
    """{probe object: (B, steps, ...)} from {probe index: (B, steps, ...)}
    with each probe's period applied."""
    out = {}
    for bp in model.probes:
        if bp.sparse:
            continue
        v = traces[bp.index]
        if bp.period_steps > 1:
            v = v[:, bp.period_steps - 1::bp.period_steps]
        out[bp.obj] = v
    return out


def _run_local(sim, input_tables, n_steps, graph_steps):
    tables = [torch.as_tensor(t).transpose(0, 1) for t in input_tables]
    runner = BatchedEpisodes(sim, tables, graph_steps=graph_steps)
    bufs = runner.run(n_steps) or {}
    traces = {k: np.swapaxes(to_host(v), 0, 1) for k, v in bufs.items()}
    return _dense_out(sim.model, traces), runner.state


def _run_model_sharded(sim, input_tables, n_steps, mesh, model_axis):
    """This rank's episodes, one after another, through the step sharded
    over ``model_axis`` (the Simulator's own if it was built on the mesh,
    else one made here with the Simulator's state and parameters
    sliced)."""
    from ..nef.executor import StepShard, make_step_fn, step_layout
    from .sharding import shard_tree
    if sim.shard is not None:
        step, params, state0 = sim._step_fn, sim.params, sim.state
    else:
        n = mesh.shape[model_axis]
        shard = StepShard(mesh.coord(model_axis), n, mesh.group(model_axis))
        s_axes, p_axes = step_layout(sim.model, sim.params, n)
        step = make_step_fn(sim.model, dtype=sim.dtype,
                            matmul_dtype=sim.matmul_dtype, device=sim.device,
                            shard=shard)
        params = shard_tree(sim.params, p_axes, shard.rank, n)
        state0 = shard_tree(sim.state, s_axes, shard.rank, n)
    dense = [bp for bp in sim.model.probes if not bp.sparse]
    cols = [torch.as_tensor(np.asarray(t, np.float32)).to(sim.device)
            for t in input_tables]
    B = cols[0].shape[0] if cols else 1
    traces = {bp.index: [] for bp in dense}
    finals = []
    for b in range(B):
        state = pytree.tree_map(lambda x: x.clone(), state0)
        rows = {bp.index: [] for bp in dense}
        for i in range(n_steps):
            state, emits = step(state, [c[b, min(i, c.shape[1] - 1)]
                                        for c in cols], params)
            for bp in dense:
                rows[bp.index].append(emits[bp.index])
        for bp in dense:
            traces[bp.index].append(torch.stack(rows[bp.index]))
        finals.append(state)
    traces = {k: to_host(torch.stack(v)) for k, v in traces.items()}
    final = pytree.tree_map(lambda *xs: torch.stack(xs), *finals)
    return _dense_out(sim.model, traces), final


def run_seed_sweep(sims, n_steps: int, segment_steps: int = 1000):
    """Run each built Simulator's episode in turn (models of different
    seeds have different parameters, which one batch cannot share; each
    Simulator replays its own CUDA graphs).  Returns a list of
    {probe object: (n_steps, ...)} per sim, this run's rows only."""
    results = []
    for sim in sims:
        dense = [bp for bp in sim.model.probes if not bp.sparse]
        before = {bp.index: sim.probe_data(bp.obj).shape[0] for bp in dense}
        sim.run_steps(n_steps, segment_steps=segment_steps)
        results.append({bp.obj: sim.probe_data(bp.obj)[before[bp.index]:]
                        for bp in dense})
    return results
