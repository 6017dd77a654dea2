"""The device step loop of the Simulator's segments, batched episodes
(``parallel.trials``), served bundles (``export.ServingModel``) and
closed-loop ticks (``Simulator.run_table``).

A step reads the input row at a device row index, calls the user's step,
writes each dense probe value into a device buffer at a device position
index and copies the new state into state leaves whose addresses stay
fixed; both indices advance on the device, so a step needs nothing from
the host.  On a CUDA device a run replays ``unit``-step CUDA graphs, then
one-step graphs for the rest, each captured on first use after one
warm-up step on a side stream and dropped when the table or the buffers
change; on the CPU, or with ``eager`` set, the step runs eagerly.  A
failed capture raises; nothing falls back.  Each capture is a
``sim.capture`` span and counts ``sim.captures`` (``utils.profiling``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.quantize import QTensor
from ..utils import profiling

__all__ = ["GRAPH_STEPS", "StepLoop", "flatten", "to_host"]

#: steps per captured CUDA graph: of 1, 10 and 100, 10 was the fastest at
#: ssp_dim 97 / 800 LIF per VCO on an H100 (PERF.md)
GRAPH_STEPS = 10


def flatten(tree) -> list:
    """Leaves in ``jax.tree_util.tree_flatten`` order: dict keys sorted,
    lists in order, a QTensor's payload then its scales."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten(v)]
    if isinstance(tree, QTensor):
        return [tree.q, tree.s]
    return [tree]


def to_host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _capture(device, leaves, pos, advance, steps: int,
             same_stream: bool = False):
    """The CUDA graph of ``steps`` consecutive ``advance()`` calls,
    captured after one warm-up call on a side stream into buffer row 0
    (``pos`` zeroed); ``leaves`` (the state and the device indices) are
    restored after the warm-up.  ``same_stream``: capture on the warm-up's
    stream (a sharded step: its NCCL communicators are warmed up on the
    stream that captures their collectives)."""
    saved = [x.clone() for x in leaves]
    pos.zero_()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        advance()
    torch.cuda.current_stream(device).wait_stream(side)
    for x, s in zip(leaves, saved):
        x.copy_(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side if same_stream else None):
        for _ in range(steps):
            advance()
    return g


class StepLoop:
    """Steps ``step(state, x, params) -> (new state, emits)`` on
    ``state``'s leaves on ``device``.  ``x`` is the table row at the row
    index (None without a table); ``params`` may be replaced (then drop
    the graphs).  Each key of ``probes`` names an emit and gives the
    shape of one buffer row (batched episodes: ``(B,) + shape``).
    ``one_index``: the table and the buffers have the same rows, so one
    index, never clamped, serves both (else steps past the table repeat
    its last row).  ``same_stream``: capture on the warm-up's stream (a
    step whose collectives run over a mesh)."""

    def __init__(self, device, step: Callable, state, params,
                 probes: Dict[object, tuple], *,
                 graph_steps: int = GRAPH_STEPS, one_index: bool = False,
                 same_stream: bool = False):
        self.device = torch.device(device)
        self.step = step
        self.state = state
        self.leaves = flatten(state)
        self.params = params
        self.probes = dict(probes)
        self.bufs: Dict[object, torch.Tensor] = {}
        self.table: Optional[torch.Tensor] = None
        self.row = torch.zeros(1, dtype=torch.long, device=self.device)
        self.pos = self.row if one_index else torch.zeros_like(self.row)
        self.graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}
        self.graph_steps = int(graph_steps)
        self.same_stream = same_stream
        # step eagerly on a CUDA device too (chip_smoke.py holds the graph
        # replay to this)
        self.eager = False

    @property
    def graphed(self) -> bool:
        """Whether runs replay CUDA graphs (else they step eagerly)."""
        return self.device.type == "cuda" and not self.eager

    def use_table(self, table: Optional[torch.Tensor]) -> None:
        """Read the input rows from ``table`` (the graphs of another table
        are dropped)."""
        if table is not self.table:
            self.table = table
            self.graphs.clear()

    def ensure_buffers(self, rows: int) -> None:
        """Dense-probe device buffers of at least ``rows`` rows."""
        if not self.probes or (
                self.bufs and next(iter(self.bufs.values())).shape[0] >= rows):
            return
        self.bufs = {k: torch.zeros((rows,) + tuple(shape),
                                    dtype=torch.float32, device=self.device)
                     for k, shape in self.probes.items()}
        self.graphs.clear()

    def advance(self) -> None:
        """One step: the input row at the row index, the user's step, the
        dense probes into their buffers at the position index, the new
        state copied back, both indices advanced."""
        x = None
        if self.table is not None:
            row = self.row
            if self.pos is not self.row:
                row = torch.clamp(row, max=self.table.shape[0] - 1)
            x = self.table.index_select(0, row)[0]
        new, emits = self.step(self.state, x, self.params)
        for k, buf in self.bufs.items():
            buf.index_copy_(0, self.pos,
                            emits[k].reshape((1,) + buf.shape[1:]))
        for dst, src in zip(self.leaves, flatten(new)):
            if src is not dst:
                dst.copy_(src)
        self.row += 1
        if self.pos is not self.row:
            self.pos += 1

    def graph(self, steps: int) -> "torch.cuda.CUDAGraph":
        """The CUDA graph of ``steps`` consecutive :meth:`advance` calls,
        captured on first use."""
        g = self.graphs.get(steps)
        if g is None:
            extra = [] if self.pos is self.row else [self.pos]
            with profiling.span("sim.capture"):
                g = self.graphs[steps] = _capture(
                    self.device, self.leaves + [self.row] + extra, self.pos,
                    self.advance, steps, same_stream=self.same_stream)
            profiling.count_traced("sim.captures")
        return g

    def prepare(self, steps: int, unit: Optional[int] = None) -> None:
        """Buffers of ``steps`` rows and, when graphed, the graphs a run
        of ``steps`` replays: ``unit``-step graphs (``graph_steps`` by
        default), then one-step graphs for the rest."""
        self.ensure_buffers(steps)
        if self.graphed:
            unit = unit or self.graph_steps
            if steps >= unit:
                self.graph(unit)
            if steps % unit:
                self.graph(1)

    def start(self, row: int = 0) -> None:
        """Point the next step at table row ``row`` and buffer row 0."""
        self.row.fill_(row)
        if self.pos is not self.row:
            self.pos.zero_()

    def replay(self, steps: int, unit: Optional[int] = None) -> None:
        """Run ``steps`` steps from the indices as they stand (after
        :meth:`prepare` with the same ``unit``)."""
        if not self.graphed:
            for _ in range(steps):
                self.advance()
            return
        unit = unit or self.graph_steps
        n_full, rem = divmod(steps, unit)
        g = self.graph(unit) if n_full else None
        g1 = self.graph(1) if rem else None
        for _ in range(n_full):
            g.replay()
        for _ in range(rem):
            g1.replay()

    def run(self, steps: int, row: int = 0,
            unit: Optional[int] = None) -> None:
        """:meth:`prepare`, :meth:`start` at ``row``, :meth:`replay`."""
        self.prepare(steps, unit)
        self.start(row)
        self.replay(steps, unit)
