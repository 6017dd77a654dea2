"""Serving bundle: ship a built model's step, not its Python graph.

Port of :mod:`sspslam_tpu.nef.export`.  ``save_bundle(sim, path)`` writes

- ``step.pt2``: ``torch.export`` of ONE step of ``sim``'s executor, taking
  ``(state leaves, one packed input row, param leaves)`` and returning
  ``(new state leaves, the dense probes' values in meta order)``.  The
  JAX package exports a whole ``lax.scan`` segment; ``torch.export`` has
  no scan it can serialise and a loop would unroll, so the program is the
  step and the serving side loops it;
- ``arrays.npz``: the params tree and the current state, ``p<i>`` and
  ``s<i>`` in ``jax.tree_util`` leaf order (the checkpoint's order);
  bf16 and fp8 leaves as their raw bits, tagged with their dtype name;
- ``meta.json``: the JAX package's keys (dt, segment length, the input
  columns, the dense probes, the two tree specs).

``ServingModel(path)`` loads a bundle and steps it with no network, no
builder and no decoder solving.  On a CUDA device it keeps the state in
fixed tensors and replays the step as CUDA graphs of
``Simulator.GRAPH_STEPS`` steps over a device input table, as the
Simulator does; on the CPU it steps eagerly.  ``segment_steps`` is the
serving call's granularity: one input upload and one block of probe rows
per segment.  Learned state (PES decoders, Voja encoders) lives in the
state, so a bundle saved after a training run ships the learned map;
:meth:`ServingModel.load_state` swaps in a later
:meth:`Simulator.save_checkpoint` file (of either package).

Not carried (ROADMAP.md, "do not carry"): lowering for several
``platforms``.  Not yet ported: mesh-sharded bundles (a program with
collectives inside it; ``save_bundle`` refuses a sharded Simulator).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch.export.graph_signature import InputKind
from torch.export.passes import move_to_device_pass

from ..ops.quantize import QTensor
from .simulator import Simulator, _capture, _flatten, _replay

__all__ = ["save_bundle", "ServingModel"]

_PROGRAM = "step.pt2"
_NOT_CARRIED = "not carried into the port (ROADMAP.md, 'do not carry')"
_NOT_YET = "not ported yet (ROADMAP.md, Queue 1: sharded serving bundles)"

#: dtypes NumPy has no type for: stored as raw bits of the same width
_RAW_BITS = {torch.bfloat16: np.uint16, torch.float8_e4m3fn: np.uint8,
             torch.float8_e5m2: np.uint8}


# ---------------------------------------------------------------------------
# JSON-portable tree (de)construction, no pickle in the artifact
def _host_leaf(x):
    """(NumPy array, dtype tag or None) of a tree leaf; a leaf on a device
    comes back to the host first."""
    if not torch.is_tensor(x):
        return np.asarray(x), None
    x = x.detach().cpu().contiguous()
    raw = _RAW_BITS.get(x.dtype)
    if raw is None:
        return x.numpy(), None
    tag = str(x.dtype).split(".")[-1]
    signed = torch.int16 if raw == np.uint16 else torch.uint8
    return x.view(signed).numpy().view(raw), tag


def _flatten_spec(x, leaves: list):
    """The JSON spec of tree ``x``; its leaves are appended to ``leaves``
    in ``jax.tree_util`` order (dict keys sorted; a QTensor's payload,
    then its scales)."""
    if isinstance(x, QTensor):
        return {"t": "qtensor", "caxis": x.caxis,
                "c": [_flatten_spec(x.q, leaves),
                      _flatten_spec(x.s, leaves)]}
    if isinstance(x, dict):
        keys = sorted(x.keys())
        return {"t": "dict", "keys": list(keys),
                "c": [_flatten_spec(x[k], leaves) for k in keys]}
    if isinstance(x, (list, tuple)):
        return {"t": "list" if isinstance(x, list) else "tuple",
                "c": [_flatten_spec(v, leaves) for v in x]}
    leaf, tag = _host_leaf(x)
    spec = {"t": "leaf", "i": len(leaves)}
    if tag is not None:
        spec["dtype"] = tag
    leaves.append(leaf)
    return spec


def _tensor_leaf(arr: np.ndarray, tag: Optional[str]) -> torch.Tensor:
    """A stored leaf as a tensor, raw bits viewed back as their dtype."""
    if tag is None:
        return torch.from_numpy(np.array(arr))
    signed = np.int16 if arr.dtype.itemsize == 2 else np.uint8
    return torch.from_numpy(np.array(arr).view(signed)).view(
        getattr(torch, tag))


def _build(spec, leaves: list):
    """The tree of ``spec`` over ``leaves`` (one tensor per leaf index)."""
    t = spec["t"]
    if t == "qtensor":
        return QTensor(_build(spec["c"][0], leaves),
                       _build(spec["c"][1], leaves), spec["caxis"])
    if t == "dict":
        return {k: _build(c, leaves) for k, c in zip(spec["keys"], spec["c"])}
    if t in ("list", "tuple"):
        seq = [_build(c, leaves) for c in spec["c"]]
        return seq if t == "list" else tuple(seq)
    return leaves[spec["i"]]


def _input_strides(exported) -> list:
    """The strides each user input of ``exported`` was traced with, in
    call order (the state leaves, the input row, the param leaves)."""
    user = {spec.arg.name for spec in exported.graph_signature.input_specs
            if spec.kind == InputKind.USER_INPUT}
    return [node.meta["val"].stride() for node in exported.graph.nodes
            if node.op == "placeholder" and node.name in user]


def _leaf_tags(spec, tags: dict) -> dict:
    """{leaf index: dtype tag} of the tagged leaves of ``spec``."""
    if spec["t"] == "leaf":
        if "dtype" in spec:
            tags[spec["i"]] = spec["dtype"]
    else:
        for c in spec["c"]:
            _leaf_tags(c, tags)
    return tags


class _Step(torch.nn.Module):
    """One step of the executor over flat leaves: the module
    ``torch.export`` traces (the trees are rebuilt from their specs)."""

    def __init__(self, step, splits, state_spec, params_spec, probes):
        super().__init__()
        self.step = step
        self.splits = splits
        self.state_spec = state_spec
        self.params_spec = params_spec
        self.probes = probes

    def forward(self, state, x, params):
        new, emits = self.step(_build(self.state_spec, state),
                               [x[a:b] for a, b in self.splits],
                               _build(self.params_spec, params))
        return _flatten(new), [emits[i] for i in self.probes]


def _unique(labels):
    """Labels key the serving side's dicts: a repeated label gets a
    ``_2``, ``_3``, ... suffix instead of merging two probes or inputs."""
    seen, out = set(), []
    for lab in labels:
        if lab in seen:
            k = 2
            while f"{lab}_{k}" in seen:
                k += 1
            lab = f"{lab}_{k}"
        seen.add(lab)
        out.append(lab)
    return out


# ---------------------------------------------------------------------------
def save_bundle(sim: Simulator, path: str, segment_steps: int = 1000,
                platforms=None) -> None:
    """Write a serving bundle of ``sim``'s model to directory ``path``.

    The bundle's initial state is ``sim``'s CURRENT state, so a bundle
    saved after a training run ships the learned weights.
    ``segment_steps`` is the serving call's granularity (recorded in
    ``meta.json``).  ``platforms`` (lowering for several backends) is not
    carried: anything but None raises.  The program runs on ``sim``'s
    device; :class:`ServingModel` moves it to the device it serves on."""
    if platforms is not None:
        raise NotImplementedError(
            f"save_bundle(platforms=...): multi-platform lowering is "
            f"{_NOT_CARRIED}; the program is moved to the serving device "
            f"at load")
    if getattr(sim, "shard", None) is not None:
        raise NotImplementedError(
            f"save_bundle: a Simulator sharded over a mesh (its step holds "
            f"collectives): sharded serving is {_NOT_YET}")
    model = sim.model
    splits = sim._input_splits()
    width = splits[-1][1] if splits else 0
    dense = [bp for bp in model.probes if not bp.sparse]

    p_leaves, s_leaves = [], []
    params_spec = _flatten_spec(sim.params, p_leaves)
    state_spec = _flatten_spec(sim.state, s_leaves)
    program = _Step(sim._step_fn, splits, state_spec, params_spec,
                    [bp.index for bp in dense])
    args = (_flatten(sim.state),
            torch.zeros(width, dtype=torch.float32, device=sim.device),
            _flatten(sim.params))
    # one real step first (its result dropped): a table a node function
    # caches at first use (ops/vsa's DFT matrices) must be cached as a
    # tensor, not as the tracer's stand-in
    program(*args)
    exported = torch.export.export(program, args)

    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, _PROGRAM))
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"p{i}": a for i, a in enumerate(p_leaves)},
             **{f"s{i}": a for i, a in enumerate(s_leaves)})

    in_labels = _unique([(n.label or f"input_{i}")
                         for i, n in enumerate(model.input_nodes)])
    pr_labels = _unique([(getattr(bp.obj, "label", None)
                          or f"probe_{bp.index}") for bp in dense])
    meta = {
        "format_version": 1,
        "dt": sim.dt,
        "segment_steps": int(segment_steps),
        "n_steps_at_export": int(sim.n_steps),
        "platforms": [sim.device.type],
        "input_width": width,
        "inputs": [{"label": lab, "a": a, "b": b}
                   for lab, (a, b) in zip(in_labels, splits)],
        # dense probes only: sparse (weights / encoders) snapshots are
        # read from the state, which serving consumers hold
        "probes": [{"index": bp.index, "label": lab,
                    "shape": list(bp.shape),
                    "period_steps": bp.period_steps}
                   for lab, bp in zip(pr_labels, dense)],
        "params_spec": params_spec,
        "state_spec": state_spec,
        "mesh": None,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


class ServingModel:
    """Load and step a bundle written by :func:`save_bundle`, on
    ``device`` (the card unless the caller names the CPU).

    Needs only torch and NumPy: the network, the builder and the solvers
    never run in the serving process.

        m = ServingModel("/path/to/bundle")
        out = m.run(xs_table)          # {probe label: (n, ...) array}

    ``xs_table`` rows are the packed input columns (``meta["inputs"]``
    gives each node's column range).  The state carries across calls;
    :meth:`reset` restores the exported state."""

    def __init__(self, path: str, *, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingModel: device='cuda' but no CUDA "
                               "device is available")
        program = os.path.join(path, _PROGRAM)
        if (not os.path.exists(program)
                and os.path.exists(os.path.join(path, "step.jaxexport"))):
            raise NotImplementedError(
                f"{path} is a JAX package bundle (step.jaxexport, no "
                f"{_PROGRAM}): StableHLO programs are {_NOT_CARRIED}; "
                f"export the port's Simulator of the model instead")
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("mesh"):
            raise NotImplementedError(
                f"{path} is a mesh-sharded bundle: sharded serving is "
                f"{_NOT_YET}")
        self.device = device
        exported = move_to_device_pass(
            torch.export.load(program), device)
        self._module = exported.module()
        with np.load(os.path.join(path, "arrays.npz")) as data:
            p = [data[f"p{i}"] for i in range(
                sum(1 for k in data.files if k.startswith("p")))]
            s = [data[f"s{i}"] for i in range(
                sum(1 for k in data.files if k.startswith("s")))]

        # each leaf laid out with the strides the step was traced with
        # (the live Simulator's): a kernel picked for a transposed operand
        # sums in another order on the card than one for a copy (the
        # clean-up's sample bank is Fortran-ordered)
        strides = _input_strides(exported)

        def tensors(arrays, spec, strides):
            tags = _leaf_tags(spec, {})
            out = []
            for i, (a, st) in enumerate(zip(arrays, strides)):
                t = _tensor_leaf(a, tags.get(i))
                out.append(torch.empty_strided(
                    t.shape, st, dtype=t.dtype, device=device).copy_(t))
            return out

        self._params = tensors(p, self.meta["params_spec"],
                               strides[len(s) + 1:])
        self.params = _build(self.meta["params_spec"], self._params)
        self._state0 = tensors(s, self.meta["state_spec"], strides[:len(s)])
        # the state tensors keep their addresses (the graphs read them)
        self._state = [x.clone() for x in self._state0]
        self.state = _build(self.meta["state_spec"], self._state)
        self.segment_steps = int(self.meta["segment_steps"])
        self._probes = self.meta["probes"]
        self._table = torch.zeros((self.segment_steps, self.input_width),
                                  dtype=torch.float32, device=device)
        self._bufs = [torch.zeros((self.segment_steps,) + tuple(d["shape"]),
                                  dtype=torch.float32, device=device)
                      for d in self._probes]
        self._row = torch.zeros(1, dtype=torch.long, device=device)
        self._graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}
        # subsampled probes take their thinning phase from the exported
        # step counter: a bundle saved mid-run continues the live
        # Simulator's sampling grid
        self._n_steps0 = int(self.meta.get("n_steps_at_export", 0))
        self.n_steps = self._n_steps0

    @property
    def input_width(self) -> int:
        return int(self.meta["input_width"])

    def reset(self) -> None:
        for dst, src in zip(self._state, self._state0):
            dst.copy_(src)
        self.n_steps = self._n_steps0

    def load_state(self, checkpoint_path: str) -> None:
        """Swap in a state saved by ``Simulator.save_checkpoint`` (a later
        training checkpoint of the same model, from either package); its
        step counter is restored too, so subsampled probes stay on the
        originating Simulator's sampling grid."""
        if (not os.path.exists(checkpoint_path)
                and os.path.exists(checkpoint_path + ".npz")):
            checkpoint_path += ".npz"
        with np.load(checkpoint_path) as f:
            n = int(f["n_leaves"])
            leaves = [f[f"leaf_{i}"] for i in range(n)]
            n_steps = int(f["n_steps"])
        if n != len(self._state):
            raise ValueError(f"checkpoint has {n} state leaves, this bundle "
                             f"{len(self._state)}")
        for dst, arr in zip(self._state, leaves):
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint leaf of shape {arr.shape} does "
                                 f"not fit the state's {tuple(dst.shape)}")
            dst.copy_(torch.as_tensor(arr))
        self.n_steps = n_steps

    # ------------------------------------------------------------------
    def _advance(self) -> None:
        """One step on the state tensors: the input row at the device row
        index, the exported step, the probe values into their buffers at
        that row, the new state copied back."""
        x = self._table.index_select(0, self._row)[0]
        new, emits = self._module(self._state, x, self._params)
        for buf, e in zip(self._bufs, emits):
            buf.index_copy_(0, self._row, e.reshape((1,) + buf.shape[1:]))
        for dst, src in zip(self._state, new):
            if src is not dst:
                dst.copy_(src)
        self._row += 1

    def _graph(self, steps: int) -> "torch.cuda.CUDAGraph":
        g = self._graphs.get(steps)
        if g is None:
            g = self._graphs[steps] = _capture(
                self.device, self._state + [self._row], self._row,
                self._advance, steps)
        return g

    def step_segment(self, xs_packed) -> Dict[str, torch.Tensor]:
        """Advance exactly ``segment_steps`` steps.  Returns the raw emit
        dict ``{str(probe index): (segment_steps, ...) tensor}`` on the
        serving device."""
        seg = self.segment_steps
        if tuple(xs_packed.shape) != (seg, self.input_width):
            raise ValueError(f"xs_packed must be ({seg}, {self.input_width})"
                             f", got {tuple(xs_packed.shape)}")
        self._table.copy_(torch.as_tensor(xs_packed, dtype=torch.float32))
        if self.device.type == "cuda":
            self._graph(Simulator.GRAPH_STEPS)
            if seg % Simulator.GRAPH_STEPS:
                self._graph(1)
            self._row.zero_()
            _replay(self._graph, seg, Simulator.GRAPH_STEPS)
        else:
            self._row.zero_()
            for _ in range(seg):
                self._advance()
        self.n_steps += seg
        return {str(d["index"]): buf.clone()
                for d, buf in zip(self._probes, self._bufs)}

    def run(self, xs_table, probes: Optional[list] = None
            ) -> Dict[str, np.ndarray]:
        """Run ``len(xs_table)`` steps in segments.  Returns ``{probe
        label: (rows, ...) array}``, subsampled probes thinned at their
        ``period_steps``.

        When the length is not a multiple of ``segment_steps`` the last
        segment is padded by repeating the last input row: its probe rows
        are trimmed, but the STATE advances to the segment boundary on the
        repeated row.  Use segment multiples where a later call must
        continue exactly from the last row."""
        xs_table = np.asarray(xs_table, np.float32)
        n = xs_table.shape[0]
        seg = self.segment_steps
        descs = [d for d in self._probes
                 if probes is None or d["label"] in probes]
        out = {d["label"]: [] for d in descs}
        done = 0
        while done < n:
            xs = xs_table[done:done + seg]
            take = xs.shape[0]
            if take < seg:
                xs = np.concatenate(
                    [xs, np.repeat(xs[-1:], seg - take, axis=0)])
            cum = self.n_steps
            emits = self.step_segment(xs)
            for d in descs:
                # sliced on the device; the host copy waits for the final
                # concatenate, so segments queue without a readback each
                e = emits[str(d["index"])][:take]
                p = d["period_steps"]
                if p > 1:
                    phase = (p - 1 - cum % p) % p
                    e = e[phase::p]
                out[d["label"]].append(e)
            done += take
        return {d["label"]: (torch.cat(out[d["label"]]).cpu().numpy()
                             if out[d["label"]]
                             else np.zeros((0,) + tuple(d["shape"])))
                for d in descs}
