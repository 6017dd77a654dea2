"""Closed-loop (robot-in-the-loop) stepping: host code in the sensory loop.

Port of :mod:`sspslam_tpu.nef.realtime`.  A host callback every dt would
put a device round trip in every millisecond of simulated time, so the
exchange is tick-granular: the device integrates a short fixed chunk of
steps, then the host reads the decoded probes and supplies the next
chunk's inputs.  Control loops run at 10-100 Hz against a 1 kHz neural
dt, so a tick of 10-100 steps matches the physical architecture.

    session = ClosedLoopSession(sim, live_inputs=[vel], outputs=[p_out],
                                tick_steps=20)
    while not done:
        out = session.tick({vel: controller(est)})   # (20, d) per probe
        est = out[p_out][-1]

On the card a tick is ONE CUDA graph of ``tick_steps`` of the Simulator's
steps (``Simulator.run_table``), captured once per tick length and
replayed every tick.  The graph reads its input rows from a device table the
session owns; each tick packs its rows into a pinned host buffer and
copies them into that table before the replay, so nothing is recaptured
per tick.  The probe rows come back to the host once per tick, which is
the loop's synchronisation point.  On the CPU the tick steps eagerly.

Nodes not marked live keep their build-time behaviour (TimeTable /
function-of-time tabulation).  The state (neurons, filters, learned PES /
Voja weights) carries across ticks exactly as in an uninterrupted run:
a tick runs the step ``run_steps`` runs.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .graph import Node, Probe

__all__ = ["ClosedLoopSession"]


class ClosedLoopSession:
    """Step a built :class:`Simulator` in fixed ticks with host-supplied
    inputs.

    Parameters
    ----------
    sim : Simulator
        A built simulator.  The session advances ``sim.state`` /
        ``sim.n_steps`` in place; interleaving with ``sim.run_steps`` is
        allowed (e.g. an open-loop warm-up before closing the loop; the
        tick graph is captured again after a run, which replaces the
        table the steps read).
    live_inputs : sequence of Node, optional
        Input nodes the host supplies each tick.  Nodes omitted here keep
        their tabulated (TimeTable / f(t)) behaviour.  Defaults to ALL
        input nodes.
    outputs : sequence of Probe, optional
        Dense probes returned from :meth:`tick`.  Defaults to all dense
        probes.  Probe synapses carry across ticks (their filter state is
        part of the state).
    tick_steps : int
        Simulation steps per tick (dt units); one graph per value.
    record : bool
        Also append tick emissions to ``sim``'s probe data so
        ``sim.data[probe]`` afterwards covers the closed-loop run (dense
        full-rate probes only).  Sparse (weights / encoders) probes are
        snapshotted independently of ``record``: whenever a tick crosses
        their sample period, the snapshot is taken at the tick boundary
        and the true step recorded.
    """

    def __init__(self, sim, live_inputs: Optional[Sequence[Node]] = None,
                 outputs: Optional[Sequence[Probe]] = None,
                 tick_steps: int = 10, record: bool = False):
        self.sim = sim
        self.tick_steps = int(tick_steps)
        if self.tick_steps < 1:
            raise ValueError("tick_steps must be >= 1")
        self.record = record
        model = sim.model
        live = (list(model.input_nodes) if live_inputs is None
                else list(live_inputs))
        known = {id(n) for n in model.input_nodes}
        for n in live:
            if id(n) not in known:
                raise ValueError(f"{n} is not an input node of this model "
                                 "(only function-of-time / TimeTable nodes "
                                 "can be driven live)")
        self._live_ids = {id(n) for n in live}
        self._splits = sim.input_splits
        self._nodes = list(model.input_nodes)

        if outputs is None:
            self._out_probes = [bp for bp in model.probes if not bp.sparse]
        else:
            by_obj = {id(bp.obj): bp for bp in model.probes}
            self._out_probes = []
            for p in outputs:
                bp = by_obj.get(id(p))
                if bp is None:
                    raise ValueError(f"{p} is not a probe of this model")
                if bp.sparse:
                    raise ValueError(
                        "sparse (weights/encoders) probes cannot be tick "
                        "outputs; they are snapshotted automatically when a "
                        "tick crosses their sample period — read "
                        "sim.data[probe] after the run")
                self._out_probes.append(bp)
        # sparse probes are snapshotted at most once per tick (the state
        # only exists at tick boundaries): a period shorter than the tick
        # gives fewer samples than run_steps would; say so once
        fast = [bp for bp in model.probes
                if bp.sparse and bp.period_steps < self.tick_steps]
        if fast:
            warnings.warn(
                f"{len(fast)} sparse probe(s) have sample periods shorter "
                f"than tick_steps={self.tick_steps}: closed-loop ticks "
                "snapshot at most once per tick (at the tick-end step), so "
                "they will record fewer samples than run_steps would; "
                "shorten tick_steps or lengthen sample_every for a full "
                "sample grid", stacklevel=2)
        width = self._splits[-1][1] if self._splits else 0
        cuda = sim.device.type == "cuda"
        # the table the tick's steps read (the session's own, so the
        # Simulator keeps its graphs), and the pinned rows copied into it
        self._table = torch.zeros((self.tick_steps, width),
                                  dtype=torch.float32, device=sim.device)
        self._rows = torch.zeros((self.tick_steps, width),
                                 dtype=torch.float32, pin_memory=cuda)
        self._copied = torch.cuda.Event() if cuda else None

    # ------------------------------------------------------------------
    def compile(self) -> None:
        """Capture the tick's graph outside any latency-sensitive region,
        without advancing the simulation (the capture's warm-up step is
        undone)."""
        self.sim.compile_table(self._table)

    @property
    def t(self) -> float:
        """Current simulation time (end of the last tick)."""
        return self.sim.n_steps * self.sim.dt

    def _pack_tick(self, inputs: Dict[Node, np.ndarray], xs: np.ndarray):
        """Write the tick's (tick_steps, width) input rows into ``xs``."""
        sim, seg = self.sim, self.tick_steps
        for n in inputs:
            if id(n) not in self._live_ids:
                raise ValueError(f"{n} was not declared in live_inputs")
        tabulated = None
        for i, (node, (a, b)) in enumerate(zip(self._nodes, self._splits)):
            if id(node) in self._live_ids:
                if node not in inputs:
                    raise ValueError(f"live input {node} missing from tick()")
                v = np.asarray(inputs[node], np.float32)
                if v.ndim <= 1:           # constant over the tick
                    xs[:, a:b] = v.reshape(1, -1)
                else:                     # per-step rows (seg, size)
                    if v.shape != (seg, b - a):
                        raise ValueError(
                            f"input for {node}: expected shape ({seg}, "
                            f"{b - a}) or ({b - a},), got {v.shape}")
                    xs[:, a:b] = v
            else:
                if tabulated is None:
                    # tabulate only the nodes not driven live (a live node's
                    # build-time output may be a per-step Python callable)
                    tabulated = sim.tabulate_inputs(
                        seg, only={id(n) for n in self._nodes}
                        - self._live_ids)
                xs[:, a:b] = tabulated[i]

    def tick(self, inputs: Optional[Dict[Node, np.ndarray]] = None
             ) -> Dict[Probe, np.ndarray]:
        """Advance ``tick_steps`` steps and return the decoded outputs.

        ``inputs[node]`` is either a ``(size,)`` vector held constant over
        the tick (zero-order hold, the usual controller output) or a
        ``(tick_steps, size)`` array of per-dt rows.  Returns ``{probe:
        (tick_steps, d) ndarray}``; copying the rows to the host is the
        loop's synchronisation point."""
        if self._copied is not None:
            # the previous tick's copy must have read the pinned rows
            self._copied.synchronize()
        self._pack_tick(inputs or {}, self._rows.numpy())
        if self._splits:
            self._table.copy_(self._rows, non_blocking=True)
            if self._copied is not None:
                self._copied.record()
        rows = self.sim.run_table(self._table, record=self.record)
        return {bp.obj: rows[bp.index].to("cpu", copy=True).numpy()
                for bp in self._out_probes}
