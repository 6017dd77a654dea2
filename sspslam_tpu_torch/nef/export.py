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
builder and no decoder solving, through the Simulator's step loop
(:class:`.steploop.StepLoop`): the state in fixed tensors, on a CUDA
device CUDA graphs of ``GRAPH_STEPS`` steps replayed over a device input
table, on the CPU eager steps.  ``segment_steps`` is the
serving call's granularity: one input upload and one block of probe rows
per segment.  Learned state (PES decoders, Voja encoders) lives in the
state, so a bundle saved after a training run ships the learned map;
:meth:`ServingModel.load_state` swaps in a later
:meth:`Simulator.save_checkpoint` file (of either package).

A Simulator sharded over a model axis (``Simulator(mesh=...)``) writes a
SHARDED bundle, as the JAX package does: every rank of the mesh calls
``save_bundle`` together.  The traced step holds its rank's spans and its
collectives (``_c10d_functional`` all-reduces over the axis's process
group, named in the program), so there is one program per model
coordinate, ``step.<axis><c>.pt2``, written by the ranks at coordinate 0
of every other axis; ``arrays.npz`` holds the WHOLE trees (the same file
an unsharded bundle of the same build writes); ``meta.json``'s ``"mesh"``
records the JAX package's keys (``axis_names``, ``shape``, one JSON
PartitionSpec a state and a parameter leaf) and the port's (the model
axis, the program of each coordinate, the process group's name that the
programs carry, the all-reduces a step).  ``ServingModel`` is then called
on every rank of a process group of the mesh's size
(``parallel.sharding.spawn`` / ``init_rank``): it rebuilds the mesh, loads
its coordinate's program with the collectives' group renamed to its own
model group, slices the whole arrays by the recorded axes, and serves the
same rows on every rank.

Not carried (ROADMAP.md, "do not carry"): lowering for several
``platforms``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.export.graph_signature import InputKind
from torch.export.passes import move_to_device_pass

from ..ops.quantize import QTensor
from .simulator import Simulator
from .steploop import StepLoop, flatten

__all__ = ["save_bundle", "ServingModel"]

_PROGRAM = "step.pt2"
_NOT_CARRIED = "not carried into the port (ROADMAP.md, 'do not carry')"

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


def _spec_json(ax, axis: str) -> list:
    """A leaf's split axis as the JAX package's JSON PartitionSpec
    (``_spec_to_json``): ``axis`` at its dimension, None before it."""
    return [] if ax is None else [None] * ax + [axis]


def _spec_axis(entries, axis: str):
    """The dimension of a JSON PartitionSpec that is split over ``axis``
    (None: whole)."""
    for i, e in enumerate(entries):
        if e == axis or (isinstance(e, list) and axis in e):
            return i
    return None


def _collectives(gm) -> list:
    """[(node, position of its ``group_name`` argument)] of every
    ``_c10d_functional`` op that names a process group in ``gm`` and its
    submodules (``torch.export`` passes schema arguments by position)."""
    out = []
    for mod in gm.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for node in mod.graph.nodes:
            schema = getattr(node.target, "_schema", None)
            if (node.op != "call_function" or schema is None
                    or not schema.name.startswith("_c10d_functional::")):
                continue
            names = [a.name for a in schema.arguments]
            if "group_name" in names:
                out.append((node, names.index("group_name")))
    return out


def _all_reduces(gm) -> int:
    return sum(1 for node, _ in _collectives(gm)
               if node.target._schema.name.startswith(
                   "_c10d_functional::all_reduce"))


def _rename_group(gm, old: str, new: str, what: str) -> None:
    """Point every collective of ``gm`` that names process group ``old``
    at ``new``; a collective that names another group raises."""
    for node, i in _collectives(gm):
        if node.args[i] != old:
            raise RuntimeError(f"{what}: a collective names process group "
                               f"{node.args[i]!r}, the bundle records "
                               f"{old!r}")
        node.update_arg(i, new)
    for mod in gm.modules():
        if isinstance(mod, torch.fx.GraphModule):
            mod.recompile()


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
        return flatten(new), [emits[i] for i in self.probes]


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
    device; :class:`ServingModel` moves it to the device it serves on.

    A Simulator sharded over a model axis: every rank of its mesh calls
    this together (it gathers the trees and steps once with its
    collectives); the bundle is complete when it returns on any rank."""
    if platforms is not None:
        raise NotImplementedError(
            f"save_bundle(platforms=...): multi-platform lowering is "
            f"{_NOT_CARRIED}; the program is moved to the serving device "
            f"at load")
    model = sim.model
    shard = getattr(sim, "shard", None)
    splits = sim.input_splits
    width = splits[-1][1] if splits else 0
    dense = [bp for bp in model.probes if not bp.sparse]

    params, state = sim.params, sim.state
    if shard is not None:
        # the whole trees, in an unsharded bundle's leaf order and layout
        from ..parallel.sharding import gather_tree
        params = gather_tree(params, sim._layout[1], sim.mesh, sim.axis)
        state = sim.whole_state()
    p_leaves, s_leaves = [], []
    params_spec = _flatten_spec(params, p_leaves)
    state_spec = _flatten_spec(state, s_leaves)
    # the rank's slices have the whole trees' structure: one spec serves
    program = _Step(sim._step_fn, splits, state_spec, params_spec,
                    [bp.index for bp in dense])
    args = (flatten(sim.state),
            torch.zeros(width, dtype=torch.float32, device=sim.device),
            flatten(sim.params))
    # one real step first (its result dropped): a table a node function
    # caches at first use (ops/vsa's DFT matrices) must be cached as a
    # tensor, not as the tracer's stand-in
    program(*args)
    os.makedirs(path, exist_ok=True)
    if shard is None:
        torch.export.save(torch.export.export(program, args),
                          os.path.join(path, _PROGRAM))
        mesh_meta = None
    else:
        mesh_meta = _save_programs(sim, program, args, path)
        if sim.mesh.rank != 0:
            dist.barrier()
            return

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
        "mesh": mesh_meta,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if shard is not None:
        dist.barrier()


def _save_programs(sim: Simulator, program, args, path: str) -> dict:
    """The programs of a sharded ``sim``, one a model coordinate, traced
    and written by the ranks at coordinate 0 of every other axis; returns
    ``meta.json``'s ``"mesh"`` (on every rank).  Every rank learns every
    writer's result before any raises, so no rank waits on one that
    failed."""
    mesh, axis = sim.mesh, sim.axis
    coord = mesh.coord(axis)
    live = len(sim.shard.log)        # the all-reduces of the real step
    group = mesh.group(axis).group_name
    entry = None
    if all(mesh.coord(a) == 0 for a in mesh.axis_names if a != axis):
        name = f"step.{axis}{coord}.pt2"
        try:
            exported = torch.export.export(program, args)
            gm = exported.graph_module
            groups = sorted({n.args[i] for n, i in _collectives(gm)})
            n_ar = _all_reduces(gm)
            error = None
            if n_ar != live:
                error = (f"the program of {axis} coordinate {coord} holds "
                         f"{n_ar} all-reduces, the live step {live}")
            elif groups != [group]:
                error = (f"the program of {axis} coordinate {coord} names "
                         f"process groups {groups}, not its {axis} group "
                         f"{group!r}")
            else:
                torch.export.save(exported, os.path.join(path, name))
        except Exception as e:      # every rank raises below
            error = f"{axis} coordinate {coord}: {e!r}"
        entry = {"coord": coord, "file": name, "group": group,
                 "error": error}
    entries = [None] * dist.get_world_size()
    dist.all_gather_object(entries, entry)
    entries = [e for e in entries if e is not None]
    errors = [e["error"] for e in entries if e["error"]]
    if errors:
        raise RuntimeError("save_bundle: " + "; ".join(errors))
    entries.sort(key=lambda e: e["coord"])
    assert [e["coord"] for e in entries] == list(range(mesh.shape[axis]))
    (group_name,) = {e["group"] for e in entries}
    return {
        "axis_names": list(mesh.axis_names),
        "shape": [mesh.shape[a] for a in mesh.axis_names],
        "state_specs": [_spec_json(a, axis)
                        for a in flatten(sim._layout[0])],
        "params_specs": [_spec_json(a, axis)
                         for a in flatten(sim._layout[1])],
        "axis": axis,
        "programs": [e["file"] for e in entries],
        "group_name": group_name,
        "all_reduces_per_step": live,
    }


def _serving_mesh(path: str, mm: dict):
    """The mesh a sharded bundle was exported for, rebuilt over this
    process group (every rank calls this together).  A process with no
    group, or a group of another size, raises before any step."""
    from ..parallel.sharding import make_mesh
    shape = [int(x) for x in mm["shape"]]
    n = int(np.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError(
            f"{path}: bundle was exported for a {shape} mesh over axes "
            f"{mm['axis_names']} ({n} devices); serve it on every rank of "
            f"a process group of {n} (parallel.sharding.spawn or "
            f"init_rank): this process has no process group")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"{path}: bundle was exported for a {shape} mesh ({n} "
            f"devices); this process group has {world} ranks")
    return make_mesh(n, tuple(mm["axis_names"]), shape)


class ServingModel:
    """Load and step a bundle written by :func:`save_bundle`, on
    ``device`` (the card unless the caller names the CPU).

    Needs only torch and NumPy: the network, the builder and the solvers
    never run in the serving process.

        m = ServingModel("/path/to/bundle")
        out = m.run(xs_table)          # {probe label: (n, ...) array}

    ``xs_table`` rows are the packed input columns (``meta["inputs"]``
    gives each node's column range).  The state carries across calls;
    :meth:`reset` restores the exported state.

    A sharded bundle is served by one ServingModel on every rank of a
    process group of its mesh's size, all made together: ``mesh`` is the
    rebuilt mesh, the device its rank's (``device`` names the type), and
    every rank returns the same rows.  ``mesh`` is None otherwise."""

    def __init__(self, path: str, *, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingModel: device='cuda' but no CUDA "
                               "device is available")
        if os.path.exists(os.path.join(path, "step.jaxexport")):
            raise NotImplementedError(
                f"{path} is a JAX package bundle (step.jaxexport): "
                f"StableHLO programs are {_NOT_CARRIED}; export the port's "
                f"Simulator of the model instead")
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        mm = self.meta.get("mesh")
        program = os.path.join(path, _PROGRAM)
        self.mesh = None
        if mm:
            self.mesh = _serving_mesh(path, mm)
            if device.type != self.mesh.device.type:
                raise ValueError(f"ServingModel: device {device} on ranks "
                                 f"of {self.mesh.device.type} devices")
            device = self.mesh.device
            program = os.path.join(
                path, mm["programs"][self.mesh.coord(mm["axis"])])
        self.device = device
        exported = move_to_device_pass(
            torch.export.load(program), device)
        self._module = exported.module()
        if mm:
            # the program names the exporting mesh's process group; this
            # rank reduces over its own group of the serving mesh
            _rename_group(self._module, mm["group_name"],
                          self.mesh.group(mm["axis"]).group_name, program)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            p = [data[f"p{i}"] for i in range(
                sum(1 for k in data.files if k.startswith("p")))]
            s = [data[f"s{i}"] for i in range(
                sum(1 for k in data.files if k.startswith("s")))]
        # a sharded bundle's arrays are whole: this rank's slices
        self._state_axes = [None] * len(s)
        if mm:
            self._state_axes = [_spec_axis(e, mm["axis"])
                                for e in mm["state_specs"]]
            p = [self._slice(a, _spec_axis(e, mm["axis"]))
                 for a, e in zip(p, mm["params_specs"])]
            s = [self._slice(a, ax) for a, ax in zip(s, self._state_axes)]

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
        # the table and the buffers have segment_steps rows: one index
        self.loop = StepLoop(
            device, self._module, self._state, self._params,
            {i: tuple(d["shape"]) for i, d in enumerate(self._probes)},
            one_index=True, same_stream=self.mesh is not None)
        self.loop.use_table(self._table)
        # subsampled probes take their thinning phase from the exported
        # step counter: a bundle saved mid-run continues the live
        # Simulator's sampling grid
        self._n_steps0 = int(self.meta.get("n_steps_at_export", 0))
        self.n_steps = self._n_steps0

    def _slice(self, arr: np.ndarray, ax) -> np.ndarray:
        """This rank's slice of a whole leaf along ``ax`` (None: whole)."""
        if ax is None:
            return arr
        axis = self.meta["mesh"]["axis"]
        n, c = self.mesh.shape[axis], self.mesh.coord(axis)
        size = arr.shape[ax] // n
        return np.take(arr, range(c * size, (c + 1) * size), ax)

    @property
    def input_width(self) -> int:
        return int(self.meta["input_width"])

    def reset(self) -> None:
        for dst, src in zip(self._state, self._state0):
            dst.copy_(src)
        self.n_steps = self._n_steps0

    def load_state(self, checkpoint_path: str) -> None:
        """Swap in a state saved by ``Simulator.save_checkpoint`` (a later
        training checkpoint of the same model, from either package, sharded
        or not: the file holds the whole state, which a sharded bundle's
        ranks slice by its state axes); its step counter is restored too,
        so subsampled probes stay on the originating Simulator's sampling
        grid."""
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
        for dst, arr, ax in zip(self._state, leaves, self._state_axes):
            arr = self._slice(arr, ax)
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint leaf of shape {arr.shape} does "
                                 f"not fit the state's {tuple(dst.shape)}")
            dst.copy_(torch.as_tensor(arr))
        self.n_steps = n_steps

    # ------------------------------------------------------------------
    def step_segment(self, xs_packed) -> Dict[str, torch.Tensor]:
        """Advance exactly ``segment_steps`` steps.  Returns the raw emit
        dict ``{str(probe index): (segment_steps, ...) tensor}`` on the
        serving device."""
        seg = self.segment_steps
        if tuple(xs_packed.shape) != (seg, self.input_width):
            raise ValueError(f"xs_packed must be ({seg}, {self.input_width})"
                             f", got {tuple(xs_packed.shape)}")
        self._table.copy_(torch.as_tensor(xs_packed, dtype=torch.float32))
        self.loop.run(seg)
        self.n_steps += seg
        return {str(d["index"]): self.loop.bufs[i].clone()
                for i, d in enumerate(self._probes)}

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
