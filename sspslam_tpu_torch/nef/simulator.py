"""Fixed-dt simulator: tabulate inputs, step the network, collect probes.

Port of :mod:`sspslam_tpu.nef.simulator`.  The state lives in tensors on
the Simulator's device that keep their addresses for its whole life, and
the network is stepped through :class:`.steploop.StepLoop` (``loop``):
one step reads the next input row from a table on the device, runs the
executor's step, writes every dense probe's value into a device buffer and
copies the new state back into the state tensors.  On a CUDA device a
segment replays captured graphs of ``GRAPH_STEPS`` steps (the counterpart
of the JAX package's jitted ``lax.scan``), then one-step graphs for the
rest; on the CPU the same step runs eagerly, once per step.

The run is split into segments, as in the JAX package, so sparse probes
(learned-weight snapshots with a large ``sample_every``) are read from the
state at segment boundaries, subsampled dense probes are thinned per
segment with the global step's phase, and progress can be reported.
:meth:`Simulator.run_table` runs the steps of a table the caller owns as
one graph (the closed-loop tick).

Spans and counters (``utils.profiling``, recorded only while tracing):
``sim.run_steps`` around :meth:`Simulator.run_steps`, inside it per
segment ``sim.stage`` (the input rows or table the steps read),
``sim.capture`` (each graph captured, by the loop), ``sim.replay`` (the
segment's replays, or its eager steps), ``sim.wait`` (a sync, made only
while tracing) and ``sim.probes`` (the segment's probe rows kept or
pulled); the counters ``sim.steps``, ``sim.replays`` (segments run) and
``sim.captures``.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.quantize import QTensor
from ..utils import profiling
from .builder import Model, build
from .executor import (StepShard, build_params, make_step_fn,
                       sparse_probe_value, step_layout)
from .graph import Network, Probe
from .processes import TimeTable
from .steploop import GRAPH_STEPS, StepLoop
from .steploop import flatten as _flatten
from .steploop import to_host as _host

__all__ = ["Simulator"]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, QTensor):
        return tree.to(device)
    return torch.as_tensor(np.array(tree)).to(device)


class Simulator:
    """Simulates a :class:`Network` on ``device`` (the card unless the
    caller names the CPU; ``device="cuda"`` without a card raises).

    ``mesh`` (:func:`..parallel.sharding.make_mesh`): one rank of a model
    axis ``axis``; every rank of the mesh makes its Simulator with the same
    arguments and calls the same methods in the same order.  The build
    pads batched groups to the axis size, rank 0's parameters and initial
    state are broadcast (every rank then holds bitwise the same whole
    tree), and each rank keeps its slices (:func:`executor.step_layout`)
    on the mesh's device.  The step is the sharded one (its collectives
    inside the captured graphs on the card); dense probes come out whole
    on every rank; checkpoints and sparse probes gather the state, and
    rank 0 writes the checkpoint file, the same file as an unsharded
    Simulator's.  ``mesh_stats()`` reports the collectives of a step."""

    #: steps per captured CUDA graph (:data:`.steploop.GRAPH_STEPS`)
    GRAPH_STEPS = GRAPH_STEPS

    #: default segment length when no sparse probe sets one
    DEFAULT_SEGMENT_STEPS = 1000

    def __init__(self, network: Network, dt: float = 0.001,
                 seed: Optional[int] = None, default_neuron_type=None,
                 progress: bool = False, dtype=torch.float32,
                 fuse_ensembles: bool = True, matmul_dtype=None, *,
                 device="cuda", mesh=None, axis: str = "model"):
        if mesh is not None:
            device = mesh.device
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Simulator: device='cuda' but no CUDA device "
                               "is available")
        self.device = device
        self.dt = float(dt)
        self.progress = progress
        self.dtype = dtype
        self.matmul_dtype = matmul_dtype
        self.mesh, self.axis, self.shard = mesh, axis, None
        # a mesh with the model axis runs the sharded step, even over one
        # rank (its collectives then run over a group of one)
        sharded = mesh is not None and axis in mesh.shape
        n_model = mesh.shape[axis] if sharded else 1
        self.model: Model = build(network, dt=dt, seed=seed,
                                  default_neuron_type=default_neuron_type,
                                  fuse_ensembles=fuse_ensembles,
                                  pad_batched_to=n_model, device=device)
        params = build_params(self.model, matmul_dtype=matmul_dtype,
                              device=device)
        state0 = _to_device(self.model.initial_state(), device)
        self._layout = None
        if mesh is not None:
            from ..parallel import sharding
            params, state0 = sharding.broadcast_tree([params, state0])
            if sharded:
                self.shard = StepShard(mesh.coord(axis), n_model,
                                       mesh.group(axis))
                self._layout = step_layout(self.model, params, n_model)
                params = sharding.shard_tree(params, self._layout[1],
                                             self.shard.rank, n_model)
                state0 = sharding.shard_tree(state0, self._layout[0],
                                             self.shard.rank, n_model)
        self._step_fn = make_step_fn(self.model, dtype=dtype,
                                     matmul_dtype=matmul_dtype, device=device,
                                     shard=self.shard)
        # the rank's slices of the initial state, for reset()
        self._state0 = [x.clone() for x in _flatten(state0)]
        self.state = state0
        #: each input node's (first, last + 1) columns in the packed table
        sizes = [n.size_out for n in self.model.input_nodes]
        offs = np.cumsum([0] + sizes).tolist()
        self.input_splits = list(zip(offs[:-1], offs[1:]))
        self._dense = [bp for bp in self.model.probes if not bp.sparse]
        step_fn, splits = self._step_fn, self.input_splits

        def step(state, x, params):
            xs = [] if x is None else [x[a:b] for a, b in splits]
            return step_fn(state, xs, params)
        self.loop = StepLoop(device, step, state0, params,
                             {bp.index: bp.shape for bp in self._dense},
                             graph_steps=self.GRAPH_STEPS,
                             same_stream=self.shard is not None)
        self._stage: Optional[torch.Tensor] = None   # streamed segment rows
        self._preloaded = None       # see preload_inputs()
        self._preloaded_dev = None
        self._preload_start = 0
        self.n_steps = 0
        # global step at which the dense probe buffers begin (see
        # load_checkpoint)
        self._data_start = 0
        self._probe_data: Dict[int, list] = {bp.index: []
                                             for bp in self.model.probes}
        self._sparse_steps: Dict[int, list] = {bp.index: []
                                               for bp in self.model.probes}

    @property
    def params(self):
        """The parameter tree (see :func:`executor.build_params`).  Leaves
        may be changed in place; assigning a new tree drops the graphs."""
        return self.loop.params

    @params.setter
    def params(self, params):
        self.loop.params = params
        self.loop.graphs.clear()

    # ------------------------------------------------------------------
    def tabulate_inputs(self, n_steps: int, only=None) -> list:
        """The columns of the next ``n_steps`` steps of every input node
        (f(t)-only nodes evaluated on the host, once).  ``only``: a set of
        ``id(node)``; the other nodes' columns are None (the closed-loop
        session tabulates the nodes it does not drive)."""
        cols = []
        for node in self.model.input_nodes:
            if only is not None and id(node) not in only:
                cols.append(None)
                continue
            f = node.output
            if isinstance(f, TimeTable):
                if abs(f.dt - self.dt) < 1e-9 * self.dt:
                    # array-backed node at the simulator dt: slice, don't loop
                    cols.append(f.rows(self.n_steps, n_steps))
                else:
                    # table recorded at a different dt: vectorised version of
                    # __call__'s t -> row map
                    ts = (self.n_steps + np.arange(1, n_steps + 1)) * self.dt
                    idx = np.clip(np.round((ts - f.dt) / f.dt).astype(int),
                                  0, len(f.values) - 1)
                    cols.append(f.values[idx])
                continue
            t0 = self.n_steps * self.dt
            vals = np.empty((n_steps, node.size_out), dtype=np.float32)
            for i in range(n_steps):
                vals[i] = np.asarray(f(t0 + (i + 1) * self.dt),
                                     dtype=np.float32).reshape(-1)
            cols.append(vals)
        return cols

    # the JAX package's name, which the parity tests call on both packages
    _tabulate_inputs = tabulate_inputs

    @staticmethod
    def _pack_cols(cols) -> np.ndarray:
        if not cols:
            return np.zeros((0, 0), np.float32)
        return np.concatenate(
            [np.asarray(c, np.float32) for c in cols], axis=1)

    # ------------------------------------------------------------------
    def preload_inputs(self, n_steps: int, device: bool = True) -> None:
        """Tabulate the inputs of the next ``n_steps`` steps ONCE into one
        packed table and (by default) upload it to the device: every
        segment then reads its rows there, with no host->device copy.
        Steps past the preloaded horizon repeat the last row (the device
        row index is clamped), matching :class:`TimeTable`'s clamp."""
        self._preloaded = self._pack_cols(self.tabulate_inputs(n_steps))
        self._preload_start = self.n_steps
        self._preloaded_dev = None
        if device and self._preloaded.shape[1] > 0:
            self._preloaded_dev = torch.as_tensor(self._preloaded).to(
                self.device)

    def _stage_rows(self, xs: np.ndarray) -> None:
        """Copy one segment's rows into the staging table steps read."""
        if self._stage is None or self._stage.shape[0] < xs.shape[0]:
            self._stage = torch.zeros(xs.shape, dtype=torch.float32,
                                      device=self.device)
        self.loop.use_table(self._stage)
        self._stage[:xs.shape[0]].copy_(torch.from_numpy(
            np.ascontiguousarray(xs, np.float32)))

    # ------------------------------------------------------------------
    def sync(self) -> int:
        """Wait for all queued simulation work and return the completed
        step count.  Call this before stopping a wall-clock timer."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return int(self.state["step"])

    def run(self, t_sim: float, segment_steps: Optional[int] = None):
        self.run_steps(int(round(t_sim / self.dt)),
                       segment_steps=segment_steps)

    def compile(self, n_steps: Optional[int] = None,
                segment_steps: Optional[int] = None) -> None:
        """Allocate the buffers and capture the graphs a run of ``n_steps``
        will use, WITHOUT advancing the simulation, so a timed ``run``
        measures simulation only."""
        if segment_steps is None:
            segment_steps = self._default_segment_steps(
                n_steps if n_steps is not None else self.DEFAULT_SEGMENT_STEPS)
        segs = [segment_steps]
        if n_steps is not None:
            segment_steps = min(segment_steps, n_steps)
            segs = [segment_steps]
            if n_steps % segment_steps:
                segs.append(n_steps % segment_steps)
        if self.input_splits:
            if self._preloaded_dev is not None:
                self.loop.use_table(self._preloaded_dev)
            else:
                self._stage_rows(np.zeros(
                    (max(segs), self.input_splits[-1][1]), np.float32))
        for seg in segs:
            self.loop.prepare(seg)

    def _default_segment_steps(self, n_steps: int) -> int:
        sparse = [bp for bp in self.model.probes if bp.sparse]
        if sparse:
            segment_steps = math.gcd(*[bp.period_steps for bp in sparse])
            # keep sparse periods intact but split huge segments into
            # bounded chunks when the period allows it
            while (segment_steps > 2 * self.DEFAULT_SEGMENT_STEPS
                   and segment_steps % 2 == 0):
                segment_steps //= 2
        else:
            segment_steps = self.DEFAULT_SEGMENT_STEPS
        return min(segment_steps, n_steps)

    def run_steps(self, n_steps: int, segment_steps: Optional[int] = None,
                  chain: bool = False):
        """Advance ``n_steps``.  ``chain=True`` runs whole multiples of
        ``segment_steps`` as one segment when the inputs are preloaded on
        the device (one probe buffer and one bookkeeping pass for the
        block, the same rows as unchained)."""
        with profiling.span("sim.run_steps"):
            self._run_steps(n_steps, segment_steps, chain)
        profiling.count_traced("sim.steps", n_steps)

    def _run_steps(self, n_steps: int, segment_steps: Optional[int],
                   chain: bool) -> None:
        model = self.model
        if segment_steps is None:
            segment_steps = self._default_segment_steps(n_steps)
        if self._preloaded is not None:
            packed = self._preloaded
            base = self.n_steps - self._preload_start
        else:
            packed = self._pack_cols(self.tabulate_inputs(n_steps))
            base = 0
        dev_table = self._preloaded_dev
        sparse_periods = [bp.period_steps for bp in model.probes if bp.sparse]
        done = 0
        t_start = time.time()
        while done < n_steps:
            seg = min(segment_steps, n_steps - done)
            cum = self.n_steps + done
            if sparse_periods:
                # clip the segment so every sparse-probe sample time is a
                # segment boundary (the snapshot is read from the state, so
                # it only exists at boundaries)
                to_next = min((p - cum % p) or p for p in sparse_periods)
                seg = min(seg, to_next)
            lo = base + done
            if (chain and not sparse_periods and dev_table is not None
                    and seg == segment_steps):
                seg *= max(1, (n_steps - done) // seg)
            start_row = 0
            with profiling.span("sim.stage"):
                if self.input_splits:
                    if dev_table is not None:
                        self.loop.use_table(dev_table)
                        start_row = lo
                    else:
                        xs = packed[lo:lo + seg]
                        if xs.shape[0] < seg:
                            # past the tabulated horizon: repeat the last
                            # row (TimeTable clamp semantics)
                            last = xs[-1:] if xs.shape[0] else packed[-1:]
                            xs = np.concatenate(
                                [xs, np.repeat(last, seg - xs.shape[0],
                                               axis=0)])
                        self._stage_rows(xs)
            self.loop.prepare(seg)
            self.loop.start(start_row)
            profiling.count_traced("sim.replays")
            with profiling.span("sim.replay"):
                self.loop.replay(seg)
            if self.device.type == "cuda" and profiling.tracing_on():
                with profiling.span("sim.wait"):
                    torch.cuda.synchronize(self.device)
            with profiling.span("sim.probes"):
                self._keep_probes(cum, seg)
            done += seg
            if self.progress:
                el = time.time() - t_start
                print(f"\r  sim {done}/{n_steps} steps "
                      f"({done / max(el, 1e-9):.0f} steps/s)", end="",
                      flush=True)
        if self.progress:
            print()
        self.n_steps += n_steps

    def _keep_probes(self, cum: int, seg: int) -> None:
        """Keep a finished segment's probe rows: sparse probes read from
        the state at their sample steps, dense rows cloned on the device
        (thinned to their period with the global step's phase)."""
        self._snapshot_sparse(cum, seg)
        for bp in self._dense:
            e = self.loop.bufs[bp.index][:seg]
            if bp.period_steps > 1:
                # row j is step cum+j+1; keep the steps that are
                # multiples of the period (global phase)
                phase = (bp.period_steps - 1
                         - cum % bp.period_steps) % bp.period_steps
                e = e[phase::bp.period_steps]
            # kept on the device; probe_data() copies to the host
            self._probe_data[bp.index].append(e.clone())

    def _snapshot_sparse(self, cum: int, steps: int) -> None:
        """Snapshot, from the state, every sparse probe whose sample step
        the steps (cum, cum + steps] reached, and record the step they end
        at (``run_steps`` ends its segments at every sample step, so that
        step is the sample's; a longer closed-loop tick snapshots at its
        end)."""
        for bp in self.model.probes:
            if bp.sparse and (cum // bp.period_steps
                              != (cum + steps) // bp.period_steps):
                self._probe_data[bp.index].append(
                    sparse_probe_value(self.model, self.whole_state(),
                                       bp)[None])
                self._sparse_steps[bp.index].append(cum + steps)

    # ------------------------------------------------------------------
    def compile_table(self, table: torch.Tensor) -> None:
        """Point the steps at ``table`` and capture the graph of
        ``len(table)`` steps that :meth:`run_table` replays, without
        advancing the simulation."""
        self.loop.use_table(table if self.input_splits else None)
        self.loop.prepare(table.shape[0], unit=table.shape[0])

    def run_table(self, table: torch.Tensor,
                  record: bool = False) -> Dict[int, torch.Tensor]:
        """The closed-loop tick: ``len(table)`` steps as one graph from
        ``table``, packed input rows on the device that the caller owns.
        Drops a preloaded table (now misaligned) and snapshots the sparse
        probes whose sample step it reached; ``record`` keeps the
        full-rate dense rows.  Returns {dense probe index: (steps, ...)
        views of the device buffers, valid until the next run}."""
        steps = table.shape[0]
        self.compile_table(table)
        self.loop.start()
        self.loop.replay(steps, unit=steps)
        self._snapshot_sparse(self.n_steps, steps)
        self.n_steps += steps
        self._preloaded = None
        self._preloaded_dev = None
        rows = {bp.index: self.loop.bufs[bp.index][:steps]
                for bp in self._dense}
        if record:
            for bp in self._dense:
                if bp.period_steps == 1:
                    self._probe_data[bp.index].append(
                        rows[bp.index].clone())
        return rows

    # ------------------------------------------------------------------
    @property
    def data(self):
        return _ProbeData(self)

    def trange(self, sample_every: Optional[float] = None):
        # integer stride arithmetic, matching the probes' row subsampling
        period = (1 if sample_every is None
                  else max(1, int(round(sample_every / self.dt))))
        n = self.n_steps // period
        return (self.dt * period) * np.arange(1, n + 1)

    def probe_data(self, probe: Probe) -> np.ndarray:
        bp = next(p for p in self.model.probes if p.obj is probe)
        chunks = self._probe_data[bp.index]
        if not chunks:
            return np.zeros((0,) + bp.shape)
        return np.concatenate([_host(c) for c in chunks], axis=0)

    def reset(self, keep_inputs: bool = False):
        """Back to the initial state at step 0, probe data cleared.
        ``keep_inputs``: keep a table preloaded from step 0 (and the
        graphs that read it), for runs of the same inputs under other
        params (``experiments/tune_loop_closure.py``)."""
        for dst, src in zip(_flatten(self.state), self._state0):
            dst.copy_(src)
        self.n_steps = 0
        self._data_start = 0
        if not (keep_inputs and self._preload_start == 0):
            self._preloaded = None
            self._preloaded_dev = None
            self.loop.use_table(None)
        for k in self._probe_data:
            self._probe_data[k] = []
        for k in self._sparse_steps:
            self._sparse_steps[k] = []

    # -- checkpoint / resume -------------------------------------------
    # The whole simulation state (neuron dynamics, synapse filters, learned
    # PES decoders and Voja encoders, node states) is the state tree, so a
    # checkpoint is its leaves.  The file is the JAX package's: np.savez
    # with n_steps, n_leaves and leaf_i in jax.tree_util.tree_flatten order,
    # so checkpoints move between the two packages in both directions.
    def whole_state(self):
        """The state tree, whole (gathered from the ranks under a model
        axis; the state itself otherwise)."""
        if self.shard is None:
            return self.state
        from ..parallel.sharding import gather_tree
        return gather_tree(self.state, self._layout[0], self.mesh, self.axis)

    def mesh_stats(self) -> dict:
        """The collectives the sharded step issued in its last step:
        {"all_reduces": count, "bytes": total payload} (zeros unsharded
        or before a step)."""
        log = self.shard.log if self.shard is not None else []
        return {"all_reduces": len(log), "bytes": int(sum(b for _, b in log))}

    def save_checkpoint(self, path: str):
        leaves = _flatten(self.whole_state())
        if self.mesh is not None and self.mesh.rank != 0:
            return
        np.savez(path, n_steps=self.n_steps, n_leaves=len(leaves),
                 **{f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)})

    def load_checkpoint(self, path: str):
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"   # np.savez appends the suffix save-side
        leaves = _flatten(self.state)
        axes = (_flatten(self._layout[0]) if self.shard is not None
                else [None] * len(leaves))
        with np.load(path) as f:
            n = int(f["n_leaves"])
            if n != len(leaves):
                raise ValueError(f"checkpoint has {n} state leaves, this "
                                 f"model {len(leaves)}")
            arrays = [f[f"leaf_{i}"] for i in range(n)]
            self.n_steps = int(f["n_steps"])
        for dst, arr, ax in zip(leaves, arrays, axes):
            if ax is not None:      # this rank's slice of the whole leaf
                size = arr.shape[ax] // self.shard.world
                arr = np.take(arr, range(self.shard.rank * size,
                                         (self.shard.rank + 1) * size), ax)
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint leaf of shape {arr.shape} does "
                                 f"not fit the state's {tuple(dst.shape)}")
            dst.copy_(torch.as_tensor(arr))
        # a preloaded input table was tabulated relative to the previous
        # step counter; drop it so run_steps re-tabulates from here
        self._preloaded = None
        self._preloaded_dev = None
        # rewinding past steps already simulated in THIS session must also
        # rewind the probe buffers.  Buffered dense rows cover the samples
        # in (_data_start, previous now].
        start = self._data_start
        if self.n_steps < start:
            # rewound to before this session's buffers began
            for bp in self.model.probes:
                self._probe_data[bp.index] = []
                self._sparse_steps[bp.index] = []
            self._data_start = self.n_steps
            return
        if all(not self._probe_data[bp.index]
               for bp in self.model.probes if not bp.sparse):
            # probe-empty simulator: buffers will begin at the restored step
            self._data_start = self.n_steps
        for bp in self.model.probes:
            if bp.sparse:
                keep = [i for i, s in enumerate(self._sparse_steps[bp.index])
                        if s <= self.n_steps]
                self._probe_data[bp.index] = [
                    self._probe_data[bp.index][i] for i in keep]
                self._sparse_steps[bp.index] = [
                    self._sparse_steps[bp.index][i] for i in keep]
            elif self._probe_data[bp.index]:
                p = bp.period_steps
                rows = self.n_steps // p - start // p
                full = torch.cat([torch.as_tensor(c) for c in
                                  self._probe_data[bp.index]])
                self._probe_data[bp.index] = [full[:rows]]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _ProbeData:
    def __init__(self, sim: Simulator):
        self._sim = sim

    def __getitem__(self, probe: Probe) -> np.ndarray:
        return self._sim.probe_data(probe)
