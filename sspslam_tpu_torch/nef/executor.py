"""The per-timestep function of a built Model, on torch tensors.

Port of :mod:`sspslam_tpu.nef.executor`.  ``make_step_fn(model, device=...)``
returns ``step(state, xs, params) -> (new_state, emits)``: one Python
function executing the whole network update — ensemble currents (batched
einsums), neuron dynamics, synapse filters (one multiply-add each),
PES/Voja outer-product learning, gates and probe collection.

The step is functional: it reads ``state`` and returns new tensors, never
writing into its inputs, because several phases read the OLD state after
others computed the new one (connection outputs read the old filters, the
PES error reads the old filtered error, the Alpha probe cascade reads the
stage it just replaced).  The Simulator copies the new state into its own
tensors afterwards.  The step never synchronises with the host (no
``.item()``, no host tensors, no data-dependent shapes), so a CUDA graph can
capture it; every index and constant it needs is made on the device when
the step function is made.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops import learning as learning_ops
from ..ops import vsa
from ..ops.quantize import QTensor, quantize
from .builder import BuiltConnection, BuiltProbe, Model

__all__ = ["build_params", "make_step_fn", "params_from_numpy",
           "sparse_probe_value"]


def _parse_param_dtype(matmul_dtype):
    """Normalise the ``matmul_dtype`` knob into (storage / matmul-input
    dtype, quantisation kind); (None, None) is float32 throughout.

    Accepted: None / "f32" / torch.float32 (full precision), "bf16" /
    torch.bfloat16 (bf16 storage and matmul inputs, float32 accumulation),
    "int8" / "fp8" (1-byte storage with per-slice scales, see
    ``ops/quantize.py``, applied after the contraction; matmul inputs bf16,
    accumulation float32)."""
    if matmul_dtype is None or matmul_dtype == "f32" \
            or matmul_dtype is torch.float32:
        return None, None
    if matmul_dtype == "bf16" or matmul_dtype is torch.bfloat16:
        return torch.bfloat16, None
    if matmul_dtype in ("int8", "fp8"):
        return torch.bfloat16, matmul_dtype
    raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}")


#: params whose contracted-axis length is below this stay in the cast
#: dtype: per-slice scales on a (n, 1) gate transform would outweigh the
#: 1-byte payload
_QUANT_MIN_CONTRACT = 32


def _contig(idx):
    """(start, stop) if idx is a contiguous ascending range, else None:
    a slice is cheaper than an index gather or scatter."""
    idx = np.asarray(idx)
    if idx.size and np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size)):
        return int(idx[0]), int(idx[0] + idx.size)
    return None


def _ea_batch_decode_groups(model: Model):
    """Static decodes of row-slices of the SAME fused-EA group with the same
    output width, layered so each layer's members cover disjoint rows —
    each layer runs as ONE (k, n) x (k, n, d) einsum over the whole group
    followed by row slices, instead of one sliced einsum per member (the
    two circular-convolution product arrays' square decodes in
    SLAMNetwork)."""
    by_spec = {}
    for bc in model.connections:
        if (bc.pre_kind == "ea_batch" and bc.decoders is not None
                and bc.learned_slot is None and bc.ea_rows is not None):
            key = (bc.pre.index, int(np.shape(bc.decoders)[-1]))
            by_spec.setdefault(key, []).append(bc)
    groups = {}
    for (pre_idx, d), bcs in by_spec.items():
        layers = []
        for bc in bcs:
            off, kk = bc.ea_rows
            for layer in layers:
                if all(off + kk <= o or off >= o + k
                       for (o, k), _ in layer):
                    layer.append(((off, kk), bc))
                    break
            else:
                layers.append([((off, kk), bc)])
        for li, layer in enumerate(layers):
            if len(layer) >= 2:
                groups[f"eab{pre_idx}_{d}_{li}"] = [bc for _, bc in layer]
    return groups


def _elem_decode_groups(model: Model):
    """Static (non-learned) per-element decodes off the SAME batched group
    with the same output width (e.g. the memory/error/recall taps of the
    fused SLAM trio), batched into ONE (g, n) x (g, n, d) einsum."""
    groups = {}
    for bc in model.connections:
        if (bc.pre_kind == "ea_elem" and bc.decoders is not None
                and bc.learned_slot is None):
            key = f"{bc.pre.index}_{int(np.shape(bc.decoders)[-1])}"
            groups.setdefault(key, []).append(bc)
    return {k: v for k, v in groups.items() if len(v) >= 2}


def _to(x, device, dtype=torch.float32) -> torch.Tensor:
    """A tensor on ``device`` from a NumPy array, a scalar or a tensor (a
    tensor already there with that dtype is returned as it is)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)


def _leaf_tensor(x, device) -> torch.Tensor:
    """A parameter leaf (a NumPy array, a scalar or a tensor) on ``device``:
    floats as float32, integer and boolean arrays keep their dtype, and a
    bfloat16 tensor stays bfloat16 (the clean-up's similarity bank, which
    a float32 copy would make the step cast every time)."""
    if torch.is_tensor(x) and x.dtype == torch.bfloat16:
        return x.detach().to(device)
    arr = np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr).to(device)


def _recurrent(bc: BuiltConnection) -> bool:
    """A connection whose pre and post are the same built ensemble group
    (the VCO limit-cycle feedback, any attractor recurrence).  Quantised
    storage leaves it in the cast dtype: its decoded feedback is applied
    every step, so 1-byte rounding would compound where a feedforward path
    sees it once, and it is a small share of the parameter bytes at
    scale."""
    return (bc.post_kind in ("ens", "ea_elem", "ea_batch", "neurons")
            and getattr(bc.post, "index", None) is not None
            and getattr(bc.pre, "index", "x") == bc.post.index
            and bc.pre_kind != "node")


# ---------------------------------------------------------------------------
# Model-axis sharding: which axis of each leaf a rank holds
# ---------------------------------------------------------------------------

def group_axis(n: int, be) -> Optional[int]:
    """The axis of ensemble group ``be``'s (k, n) or (n,) state that a
    model axis of ``n`` ranks splits (the JAX package's ``_group_axis``):
    a batched group its element axis when it divides, else its neuron
    axis; a single ensemble its neurons; None when nothing divides."""
    if be.batched:
        if be.k >= max(n, 2) and be.k % n == 0:
            return 0
        if be.n >= max(n, 2) and be.n % n == 0:
            return 1
        return None
    if be.n >= max(n, 2) and be.n % n == 0:
        return 0
    return None


def _spec_for(n: int, shape, shard_axis) -> Optional[int]:
    """``shard_axis`` if it divides ``n`` ways, else None (whole)."""
    if (shard_axis is None or shard_axis >= len(shape)
            or shape[shard_axis] % n != 0 or shape[shard_axis] < n):
        return None
    return shard_axis


def _maybe_q(n: int, param, shard_axis):
    """The split axis of a parameter leaf; for a :class:`QTensor` a
    QTensor of its payload's and its scale's axes (the scale drops the
    contracted axis, so it is whole when that axis is the split one)."""
    if isinstance(param, QTensor):
        q_ax = _spec_for(n, tuple(param.q.shape), shard_axis)
        caxis = param.caxis % param.q.ndim
        if (shard_axis is None or shard_axis == caxis
                or param.q.shape[shard_axis] % n != 0):
            s_ax = None
        else:
            s_ax = shard_axis - (1 if shard_axis > caxis else 0)
        return QTensor(q_ax, _spec_for(n, tuple(param.s.shape), s_ax),
                       param.caxis)
    return _spec_for(n, tuple(np.shape(param)), shard_axis)


def _row_local(bc: BuiltConnection, gaxis) -> bool:
    """A decode that stays on the rank's rows: a batched group's own
    recurrence (the VCO feedback) when the group is split over its
    elements."""
    return (bc.pre_kind == "ea_batch" and bc.post_kind == "ea_batch"
            and bc.pre.index == bc.post.index
            and gaxis.get(bc.pre.index) == 0 and bc.ea_rows is None
            and bc.jnp_function is None and bc.weights is None
            and bc.learned_slot is None)


def _row_sharded_tables(model: Model) -> Dict[str, tuple]:
    """{hoisted key: table names} a node function reads as row shards
    (its ``row_sharded`` attribute: the clean-up's sample bank, whose
    argmax the sharded step reduces across ranks)."""
    out = {}
    for info in model.node_info.values():
        hk = info.get("hoisted_key")
        names = getattr(info["node"].output, "row_sharded", ())
        if hk is not None and names:
            out[hk] = tuple(names)
    return out


def _rule_group(bc: BuiltConnection):
    """The ensemble group whose neurons index a learned leaf's rows."""
    if bc.voja_rule is not None:
        return bc.post
    if bc.pes_rule is not None:
        return bc.pre
    return None


def _check_shardable(model: Model, gaxis) -> None:
    for bc in model.connections:
        be = _rule_group(bc)
        if be is not None and be.batched and gaxis.get(be.index) is not None:
            raise NotImplementedError(
                f"connection {bc.index}: learning on a batched group split "
                f"over a model axis")
    for bp in model.probes:
        t = bp.target
        if (bp.kind == "ens_decoded" and t.batched and bp.elem_index is None
                and gaxis.get(t.index) is not None):
            raise NotImplementedError(f"probe {bp.index}: decoded probe of "
                                      f"a whole split batched group")


def _axes_like(tree):
    if isinstance(tree, dict):
        return {k: _axes_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_axes_like(v) for v in tree]
    if isinstance(tree, QTensor):
        return QTensor(None, None, tree.caxis)
    return None


def step_layout(model: Model, params, n: int):
    """(state axes, params axes): the axis of every state and parameter
    leaf that a rank of an ``n``-way model axis holds a slice of, as the
    sharded step reads them; None is whole.  Ensemble groups are split
    by :func:`group_axis` with their encoders, gains, biases, decoders and
    decode stacks, and the learned weights and activity filters of their
    neurons; a group's own recurrent decode filter follows its rows; the
    clean-up's sample bank is split over rows.  Everything else is whole
    (``params`` None: the state axes only)."""
    gaxis = {be.index: group_axis(n, be) for be in model.ensembles}
    _check_shardable(model, gaxis)
    neurons = []
    for be in model.ensembles:
        shape = (be.k, be.n) if be.batched else (be.n,)
        neurons.append({key: gaxis[be.index]
                        for key in be.neuron_type.init_state(shape)})
    filters = [None] * len(model.filter_specs)
    learned = {k: None for k in model.learned_init}
    for bc in model.connections:
        if bc.filt_index is not None and _row_local(bc, gaxis):
            filters[bc.filt_index] = 0
        be = _rule_group(bc)
        if be is not None and gaxis.get(be.index) is not None:
            learned[bc.learned_slot] = 0
            if bc.pes_act_filt_index is not None:
                filters[bc.pes_act_filt_index] = 0
    state = {"step": None, "neurons": neurons, "filters": filters,
             "learned": learned,
             "nodes": {k: None for k in model.node_state_init}}
    if params is None:
        return state, None

    p = _axes_like(params)
    for i, be in enumerate(model.ensembles):
        ga = gaxis[be.index]
        ep = params["ens"][i]
        p["ens"][i]["scaled_encoders"] = _maybe_q(n, ep["scaled_encoders"],
                                                  ga)
        for k2 in ("bias", "gain"):
            p["ens"][i][k2] = _spec_for(n, tuple(ep[k2].shape), ga)
    eab = _ea_batch_decode_groups(model)
    eab_members = {bc.index for bcs in eab.values() for bc in bcs}
    for bc in model.connections:
        entry = params["conn"].get(str(bc.index), {})
        if "D" not in entry or getattr(bc.pre, "index", None) is None:
            continue
        ga, D = gaxis[bc.pre.index], entry["D"]
        if bc.pre_kind in ("ens", "ens_view") and not bc.pre.batched \
                and ga == 0:
            p["conn"][str(bc.index)]["D"] = _maybe_q(n, D, 0)
        elif bc.pre_kind == "ea_batch" and D.ndim == 3:
            if ga == 1 or (ga == 0 and (bc.ea_rows is None
                                        or bc.index in eab_members)):
                # a member of a layered group is not read by the step: it
                # splits as the JAX package splits it
                p["conn"][str(bc.index)]["D"] = _maybe_q(n, D, ga)
    for key, bcs in _elem_decode_groups(model).items():
        ga = gaxis[bcs[0].pre.index]
        p["dstack"][key] = _maybe_q(n, params["dstack"][key],
                                    1 if ga == 1 else None)
    for key, bcs in eab.items():
        p["dstack"][key] = _maybe_q(n, params["dstack"][key],
                                    gaxis[bcs[0].pre.index])
    for bp in model.probes:
        entry = params["probe"].get(str(bp.index), {})
        t = bp.target
        if ("D" in entry and getattr(t, "index", None) is not None
                and not t.batched and gaxis[t.index] == 0):
            p["probe"][str(bp.index)]["D"] = _maybe_q(n, entry["D"], 0)
    for hk, names in _row_sharded_tables(model).items():
        for name in names:
            v = params["hoisted"].get(hk, {}).get(name)
            if v is not None and v.ndim == 2:
                p["hoisted"][hk][name] = _spec_for(n, tuple(v.shape), 0)
    return state, p


class StepShard:
    """A rank's place on the model axis of a sharded step: its index
    ``rank`` of ``world``, the axis's process group, and ``log``, one
    (op, bytes) per collective the step issued when it last ran."""

    def __init__(self, rank: int, world: int, group=None):
        self.rank, self.world, self.group = int(rank), int(world), group
        self.log = []

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced in place over the axis (a fresh tensor of the
        step's own)."""
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(t, op=red, group=self.group)
        self.log.append((op, t.numel() * t.element_size()))
        return t


def build_params(model: Model, matmul_dtype=None, *, device):
    """Parameter tree the step reads, every leaf a tensor (or a
    :class:`QTensor` of tensors) on ``device``.

    Decoders that the builder solved on the device arrive as tensors and
    stay there; host arrays are uploaded once.  ``matmul_dtype`` ("bf16")
    STORES the matmul-side parameters (encoders / decoders / transforms) in
    that dtype; "int8" / "fp8" store them as 1-byte :class:`QTensor` with
    per-slice scales over the axis each contraction reduces (encoders and
    transforms their last axis, decoders the neuron axis), where that axis
    has at least ``_QUANT_MIN_CONTRACT`` entries and the connection is not
    recurrent; the other matmul-side leaves are stored in bf16.  Bias,
    gain, learning rates and every learned weight stay float32.  Learning
    rates are 0-d tensors: changing one in place (e.g.
    ``params["hyper"]["lr"][slot].fill_(0)``) changes the next step without
    a new step function or a new CUDA graph.  So are the tables a node
    function hoists (``params["hoisted"]``: the clean-up's sample bank, the
    gates' thresholds), which the node reads from here, on ``device``.
    Filter coefficients are Python floats baked into the step."""
    device = torch.device(device)
    cast, quant_kind = _parse_param_dtype(matmul_dtype)
    cast = cast or torch.float32

    def f32(x):
        return _to(x, device)

    def p(x, caxis=None):
        if (quant_kind is not None and caxis is not None
                and np.ndim(x) >= 2
                and np.shape(x)[caxis] >= _QUANT_MIN_CONTRACT):
            return quantize(f32(x), caxis, quant_kind)
        return _to(x, device, cast)

    enc_params = [{"scaled_encoders": p(be.scaled_encoders, caxis=-1),
                   "bias": f32(be.bias), "gain": f32(be.gain)}
                  for be in model.ensembles]
    conn_const = {}
    for bc in model.connections:
        d = {}
        rec = _recurrent(bc)
        if bc.weights is not None:
            # every W form contracts its LAST axis: matmul(W, v),
            # ein("kds,s->kd"), ein("knm,km->kn")
            d["W"] = p(bc.weights, caxis=None if rec else -1)
        if bc.decoders is not None and bc.learned_slot is None:
            # decoders contract the NEURON axis: matmul(act, D),
            # ein("kn,knd->kd")
            d["D"] = p(bc.decoders, caxis=None if rec else -2)
        conn_const[str(bc.index)] = d
    probe_const = {str(bp.index): ({"D": p(bp.decoders, caxis=-2)}
                                   if bp.decoders is not None else {})
                   for bp in model.probes}
    # batched per-element decode stacks (g, n, d); the members keep their
    # own "D" entries too (read only by weights probes)
    dstack = {}
    for key, bcs in _elem_decode_groups(model).items():
        dstack[key] = p(torch.stack([f32(bc.decoders) for bc in bcs]),
                        caxis=-2)
    # fused-EA layered decode stacks: full-group (k_tot, n, d) matrices with
    # each member's (k_ea, n, d) decoders written into its rows
    for key, bcs in _ea_batch_decode_groups(model).items():
        be = bcs[0].pre
        d_out = int(np.shape(bcs[0].decoders)[-1])
        full = torch.zeros((be.k, be.n, d_out), dtype=torch.float32,
                           device=device)
        for bc in bcs:
            off, kk = bc.ea_rows
            full[off:off + kk] = f32(bc.decoders)
        dstack[key] = p(full, caxis=-2)
    lr = {}
    for bc in model.connections:
        rule = bc.pes_rule if bc.pes_rule is not None else bc.voja_rule
        if rule is not None:
            lr[bc.learned_slot] = f32(np.float32(rule.learning_rate))
    hoisted = {k: {name: _leaf_tensor(v, device)
                   for name, v in consts.items()}
               for k, consts in model.hoisted.items()}
    return {"ens": enc_params, "conn": conn_const, "probe": probe_const,
            "dstack": dstack, "hyper": {"lr": lr}, "hoisted": hoisted}


def _qtensor_from_host(x, device) -> QTensor:
    """A port QTensor from a JAX package's QTensor with NumPy children: an
    int8 payload as it is; a float8_e4m3fn payload (the ``ml_dtypes``
    dtype, which torch cannot take from NumPy) through its bytes."""
    q = np.asarray(x.q)
    if q.dtype == np.int8:
        tq = torch.from_numpy(np.array(q))
    elif q.dtype.name == "float8_e4m3fn":
        tq = torch.from_numpy(np.array(q).view(np.uint8)).view(
            torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quantised payload dtype {q.dtype}")
    s = torch.from_numpy(np.array(x.s, np.float32))
    return QTensor(tq.to(device), s.to(device), int(x.caxis))


def params_from_numpy(model: Model, np_params, *, device, matmul_dtype=None):
    """The port's params from the JAX package's ``build_params(model)`` tree
    with its leaves converted to NumPy arrays: same keys, every leaf a
    tensor on ``device`` (matmul-side leaves cast as ``build_params`` would
    cast them).  A quantised leaf (anything with ``q``, ``s`` and
    ``caxis``, as the JAX package's ``QTensor``) becomes the port's
    :class:`QTensor` with the same payload and scales.  ``model`` is the
    port's build of the same network; the tree must have exactly the keys
    the port's ``build_params`` gives it."""
    cast = _parse_param_dtype(matmul_dtype)[0] or torch.float32
    own = build_params(model, device="cpu")
    want = _key_tree(own)
    got = _key_tree(np_params)
    if got != want:
        raise ValueError("the parameter tree does not match this model's "
                         f"layout: {got} != {want}")
    device = torch.device(device)

    def leaf(path, x):
        if hasattr(x, "caxis"):
            return _qtensor_from_host(x, device)
        t = _leaf_tensor(x, device)
        if path[0] == "hoisted":
            # the dtype the node's own table has (a bf16 clean-up bank)
            return t.to(own["hoisted"][path[1]][path[2]].dtype)
        stays_f32 = path[0] == "hyper" or path[-1] in ("bias", "gain")
        return t if stays_f32 or not t.is_floating_point() else t.to(cast)

    return _map_tree(np_params, leaf)


def _map_tree(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _key_tree(tree):
    if isinstance(tree, dict):
        return {k: _key_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_key_tree(v) for v in tree]
    return None


class _Cell:
    """A value each rank of a model axis holds one summand of: its
    neurons' share of a decode, or its slice of a gathered tensor in
    place with zeros elsewhere.  ``full`` is the sum over the ranks, once
    an all-reduce has made it."""

    __slots__ = ("part", "full")

    def __init__(self, part):
        self.part, self.full = part, None


class _Lazy:
    """A connection's or probe's value still to be reduced: ``view`` of
    its cell's full value."""

    __slots__ = ("cell", "view")

    def __init__(self, cell, view=None):
        self.cell, self.view = cell, view

    def value(self):
        return self.cell.full if self.view is None else self.view(
            self.cell.full)


def _resolve(shard: "StepShard", objs) -> list:
    """``objs`` with every :class:`_Lazy` replaced by its value: the
    cells not yet reduced go out in ONE flat all-reduce (a bucket)."""
    cells, seen = [], set()
    for o in objs:
        if isinstance(o, _Lazy) and o.cell.full is None \
                and id(o.cell) not in seen:
            seen.add(id(o.cell))
            cells.append(o.cell)
    if cells:
        flat = torch.cat([c.part.reshape(-1) for c in cells])
        shard.all_reduce(flat)
        off = 0
        for c in cells:
            c.full = flat[off:off + c.part.numel()].reshape(c.part.shape)
            off += c.part.numel()
    return [o.value() if isinstance(o, _Lazy) else o for o in objs]


def _narrow(x, axis: int, start: int, length: int):
    """``x.narrow``, for a :class:`QTensor` its payload and (unless the
    axis is the contracted one) its scale."""
    if isinstance(x, QTensor):
        c = x.caxis % x.q.ndim
        s = x.s if axis == c else x.s.narrow(axis - (axis > c), start,
                                             length)
        return QTensor(x.q.narrow(axis, start, length), s, x.caxis)
    return x.narrow(axis, start, length)


def make_step_fn(model: Model, dtype=torch.float32, matmul_dtype=None, *,
                 device, shard: Optional[StepShard] = None):
    """Returns ``step(state, xs, params) -> (new_state, emits)``.

    ``state`` is the tree of ``Model.initial_state()`` as tensors on
    ``device``; ``xs`` holds one (size_out,) tensor per tabulated input node
    (``model.input_nodes`` order); ``emits`` maps each dense probe's index
    to its value this step.  ``matmul_dtype="bf16"``: encoder / decoder /
    transform matmuls take bf16 inputs and accumulate in float32 (their
    results are float32); state, filters and learned weights stay float32.
    ``"int8"`` / ``"fp8"``: the step reads :class:`QTensor` params,
    contracts the bf16-rounded activation against the 1-byte payload in
    float32 (exact: every int8 and e4m3 value is a bf16 value) and
    multiplies the output by the per-slice scale.

    ``shard``: the step of one rank of a model axis.  ``state`` and
    ``params`` are then the rank's slices (:func:`step_layout`): a split
    group computes its currents, neuron update, Voja and PES updates on
    its own rows; its decodes are partial sums, all-reduced over the axis
    where a unit of the same step reads them, and in one bucket for the
    filter updates, learning and probes; neuron-level reads of a split
    group are gathered the same way.  Every other value is whole on every
    rank, and so are the emits.
    """
    device = torch.device(device)
    if shard is not None:
        gax = {be.index: group_axis(shard.world, be)
               for be in model.ensembles}
        _check_shardable(model, gax)
        span = {}     # this rank's [lo, hi) along each split group's axis
        for be in model.ensembles:
            ga = gax[be.index]
            if ga is not None:
                size = (be.k if be.batched and ga == 0 else be.n) \
                    // shard.world
                span[be.index] = (shard.rank * size,
                                  (shard.rank + 1) * size)
        row_local = {bc.index for bc in model.connections
                     if _row_local(bc, gax)}
        row_tables = _row_sharded_tables(model)
    else:
        gax, span, row_local, row_tables = {}, {}, set(), {}
    dt = model.dt
    filt_coeffs = [(a, b) for (_shape, a, b) in model.filter_specs]
    cascade = model.filter_cascade  # Alpha synapses: out slot -> hidden slot
    mm, _ = _parse_param_dtype(matmul_dtype)

    def cast(a):
        # bf16-rounded inputs, float32 arithmetic: the products of two bf16
        # values are exact in float32, so this is a bf16 x bf16 -> f32 matmul
        return a.to(mm).to(dtype) if mm is not None else a

    def qop(op, a, b):
        """``op`` with one possibly-QTensor operand: the payload against
        the other operand, then the scale on the output (whose trailing
        axes are the param's non-contracted axes)."""
        if isinstance(b, QTensor):
            return op(cast(a), b.q.to(dtype)) * b.s
        if isinstance(a, QTensor):
            return op(a.q.to(dtype), cast(b)) * a.s
        return op(cast(a), cast(b))

    def matmul(a, b):
        return qop(torch.matmul, a, b)

    def ein(spec, a, b):
        return qop(lambda x, y: torch.einsum(spec, x, y), a, b)

    def dev_index(idx):
        return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                               device=device)

    # incoming connections per unit
    node_in: Dict[int, list] = {}
    ens_in: Dict[int, list] = {}
    ens_cur: Dict[int, list] = {}   # direct neuron-current connections
    for bc in model.connections:
        if bc.post_kind == "node":
            node_in.setdefault(id(bc.post), []).append(bc)
        elif bc.post_kind in ("ens", "ea_elem", "ea_batch"):
            ens_in.setdefault(bc.post.index, []).append(bc)
        elif bc.post_kind == "neurons":
            ens_cur.setdefault(bc.post.index, []).append(bc)
        # pes/voja handled in the learning phase

    input_index = {id(n): i for i, n in enumerate(model.input_nodes)}

    # index tensors (gathers and scatter-adds with repeated indices
    # accumulate through index_put(accumulate=True)) and node constants,
    # made on the device now so the step uploads nothing
    pre_idx, post_idx = {}, {}
    for bc in model.connections:
        if bc.pre_indices is not None and not _contig(bc.pre_indices):
            pre_idx[bc.index] = dev_index(bc.pre_indices)
        if bc.post_indices is not None and not _contig(bc.post_indices):
            post_idx[bc.index] = dev_index(bc.post_indices)
    node_const = {id(info["node"]): torch.as_tensor(
                      info["const"], dtype=dtype, device=device)
                  for info in model.node_info.values()
                  if info["kind"] == "const"}

    # fused-EA groups whose inputs EXACTLY tile the row axis (one route per
    # member, disjoint, covering [0, k)): build the group input by
    # concatenation instead of zeros + scatter-adds
    _tiled_inputs = {}
    for be_idx, bcs in ens_in.items():
        if not all(bc.post_kind == "ea_batch" and bc.ea_rows is not None
                   for bc in bcs) or len(bcs) < 2:
            continue
        order = sorted(bcs, key=lambda bc: bc.ea_rows[0])
        pos = 0
        for bc in order:
            off, kk = bc.ea_rows
            if off != pos:
                break
            pos = off + kk
        else:
            if pos == order[0].post.k:
                _tiled_inputs[be_idx] = order

    _elem_groups = _elem_decode_groups(model)
    _elem_pos = {bc.index: (key, i)
                 for key, bcs in _elem_groups.items()
                 for i, bc in enumerate(bcs)}
    _eab_pos = {bc.index: key
                for key, bcs in _ea_batch_decode_groups(model).items()
                for bc in bcs}

    def add_at(x, bc, v, row=None):
        """x with v added at bc.post_indices (of row ``row`` of a 2-D x),
        accumulating repeated indices; x is a fresh tensor of the step."""
        rng = _contig(bc.post_indices)
        if rng:
            if row is None:
                x[rng[0]:rng[1]] += v
            else:
                x[row, rng[0]:rng[1]] += v
            return x
        idx = post_idx[bc.index]
        if row is None:
            return x.index_put((idx,), v, accumulate=True)
        rows = torch.full_like(idx, row)
        return x.index_put((rows, idx), v, accumulate=True)

    def step(state, xs, params):
        enc_params = params["ens"]
        conn_const = params["conn"]
        probe_const = params["probe"]
        step_no = state["step"]
        t = (step_no.to(dtype) + 1.0) * dt
        filters = state["filters"]
        learned = state["learned"]
        node_states = state.get("nodes", {})
        new_node_states = dict(node_states)
        sig_node: Dict[int, torch.Tensor] = {}
        sig_act: Dict[int, torch.Tensor] = {}
        new_neurons = list(state["neurons"])
        dec_cache: Dict[str, torch.Tensor] = {}
        # sharded step: resolved pre values, probe values, gathered cells
        pre_memo: Dict[int, torch.Tensor] = {}
        probe_memo: Dict[int, torch.Tensor] = {}
        if shard is not None:
            shard.log = []

        def gathered(key, x, be):
            """The cell of ``x`` (this rank's slice of group ``be``'s
            (k, n) or (n,) tensor) laid into zeros of the whole shape."""
            if key not in dec_cache:
                ga, (lo, hi) = gax[be.index], span[be.index]
                part = zeros((be.k, be.n) if be.batched else (be.n,))
                part.narrow(ga, lo, hi - lo).copy_(x)
                dec_cache[key] = _Cell(part)
            return dec_cache[key]

        def batch_part(act, D, be):
            """This rank's summand of a (k, n) x (k, n, d) group decode."""
            y = ein("kn,knd->kd", act, D)
            if gax[be.index] == 1:
                return y
            lo, hi = span[be.index]
            part = zeros((be.k, y.shape[-1]))
            part[lo:hi] = y
            return part

        def elem_part(act, e, D, be):
            """This rank's summand of element ``e``'s (n,) x (n, d)
            decode: its neurons' share, or all of it on the rank holding
            the element."""
            lo, hi = span[be.index]
            if gax[be.index] == 1:
                return matmul(act[e], _narrow(D, 0, lo, hi - lo))
            if lo <= e < hi:
                return matmul(act[e - lo], D)
            return zeros((D.shape[-1],))

        def elem_group_part(key, be):
            act = sig_act[be.index]
            bcs = _elem_groups[key]
            if gax[be.index] == 1:
                acts = torch.stack([act[b.ea_elem_index] for b in bcs])
            else:
                lo, hi = span[be.index]
                zero = zeros((be.n,))
                acts = torch.stack([act[b.ea_elem_index - lo]
                                    if lo <= b.ea_elem_index < hi else zero
                                    for b in bcs])
            return ein("gn,gnd->gd", acts, params["dstack"][key])

        def split_pre_value(bc: BuiltConnection):
            """pre_value of a connection from a split group: a
            :class:`_Lazy` (or, for a group's own recurrence over its
            rows, this rank's rows)."""
            be = bc.pre
            act = sig_act[be.index]
            if bc.pre_kind in ("ens", "ens_view"):
                return _Lazy(_Cell(matmul(act, decoders_of(bc))))
            if bc.pre_kind == "ea_elem":
                if bc.index in _elem_pos:
                    key, i = _elem_pos[bc.index]
                    if key not in dec_cache:
                        dec_cache[key] = _Cell(elem_group_part(key, be))
                    return _Lazy(dec_cache[key], lambda f, i=i: f[i])
                return _Lazy(_Cell(elem_part(act, bc.ea_elem_index,
                                             decoders_of(bc), be)))
            if bc.pre_kind == "ea_batch":
                if bc.index in _eab_pos:
                    key = _eab_pos[bc.index]
                    if key not in dec_cache:
                        dec_cache[key] = _Cell(batch_part(
                            act, params["dstack"][key], be))
                    off, kk = bc.ea_rows
                    return _Lazy(dec_cache[key],
                                 lambda f, o=off, k=kk: f[o:o + k])
                D = decoders_of(bc)
                if bc.index in row_local:
                    return ein("kn,knd->kd", act, D)
                if bc.ea_rows is None:
                    return _Lazy(_Cell(batch_part(act, D, be)))
                off, kk = bc.ea_rows
                if gax[be.index] == 1:
                    return _Lazy(_Cell(ein("kn,knd->kd",
                                           act[off:off + kk], D)))
                # split over elements: this rank's rows of the member
                lo, hi = span[be.index]
                a, b = max(off, lo), min(off + kk, hi)
                part = zeros((kk, D.shape[-1]))
                if a < b:
                    part[a - off:b - off] = ein(
                        "kn,knd->kd", act[a - lo:b - lo],
                        _narrow(D, 0, a - off, b - a))
                return _Lazy(_Cell(part))
            if bc.pre_kind in ("neurons", "ea_neurons"):
                return _Lazy(gathered(("act", be.index), act, be),
                             lambda f: neuron_value(bc, f))
            raise TypeError(bc.pre_kind)

        def prefetch(bcs, extra=None):
            """Make the pre values of connections ``bcs`` (and the
            lazies in ``extra``, a dict) with ONE all-reduce for all that
            need one; kept in pre_memo (and ``extra`` updated)."""
            todo = [bc for bc in bcs if bc.index not in pre_memo]
            vals = [pre_value(bc) for bc in todo]
            keys = list(extra) if extra else []
            out = _resolve(shard, vals + [extra[k] for k in keys])
            for bc, v in zip(todo, out):
                pre_memo[bc.index] = v
            for k, v in zip(keys, out[len(todo):]):
                extra[k] = v

        def elem_decode(bc):
            """Row of the batched (g, n) x (g, n, d) group decode."""
            key, i = _elem_pos[bc.index]
            if key not in dec_cache:
                bcs = _elem_groups[key]
                act = sig_act[bc.pre.index]
                acts = torch.stack([act[b.ea_elem_index] for b in bcs])
                dec_cache[key] = ein("gn,gnd->gd", acts,
                                     params["dstack"][key])
            return dec_cache[key][i]

        def decoders_of(bc):
            if bc.learned_slot is not None:
                return learned[bc.learned_slot]
            return conn_const[str(bc.index)]["D"]

        def pre_value(bc: BuiltConnection):
            if bc.pre_kind == "node":
                v = sig_node[id(bc.pre)]
                if bc.pre_indices is not None:
                    rng = _contig(bc.pre_indices)
                    v = v[rng[0]:rng[1]] if rng else v[pre_idx[bc.index]]
                return v
            if gax.get(bc.pre.index) is not None:
                return split_pre_value(bc)
            act = sig_act[bc.pre.index]
            if bc.pre_kind in ("ens", "ens_view"):
                return matmul(act, decoders_of(bc))
            if bc.pre_kind == "ea_elem":
                if bc.index in _elem_pos:
                    return elem_decode(bc)
                return matmul(act[bc.ea_elem_index], decoders_of(bc))
            if bc.pre_kind == "ea_batch":
                if bc.index in _eab_pos:
                    # layered group decode: ONE einsum over the whole
                    # fused group, members read their row slice
                    key = _eab_pos[bc.index]
                    if key not in dec_cache:
                        dec_cache[key] = ein("kn,knd->kd", act,
                                             params["dstack"][key])
                    off, kk = bc.ea_rows
                    return dec_cache[key][off:off + kk]
                if bc.ea_rows is not None:   # fused-EA member rows
                    off, kk = bc.ea_rows
                    act = act[off:off + kk]
                return ein("kn,knd->kd", act, decoders_of(bc))
            if bc.pre_kind in ("neurons", "ea_neurons"):
                return neuron_value(bc, act)
            raise TypeError(bc.pre_kind)

        def neuron_value(bc: BuiltConnection, act):
            """A neuron-level connection's value from the group's whole
            activities."""
            if bc.pre_kind == "neurons":
                nl = bc.pre.n - bc.pre.n_pad
                if bc.ea_elem_index is not None:  # fused-group element
                    v = act[bc.ea_elem_index]
                    return v if (bc.full_weights or bc.pre.n_pad == 0) \
                        else v[:nl]
                if bc.full_weights or bc.pre.n_pad == 0:
                    return act.reshape(-1)
                return act[..., :nl].reshape(-1)
            if bc.ea_rows is not None:     # ea_neurons
                off, kk = bc.ea_rows
                return act[off:off + kk]
            return act              # (k, n) raw activities

        def current_value(bc: BuiltConnection):
            v = pre_memo[bc.index] if bc.index in pre_memo \
                else pre_value(bc)
            if isinstance(v, _Lazy):
                v = _resolve(shard, [v])[0]
            if bc.jnp_function is not None:
                v = torch.as_tensor(bc.jnp_function(v), dtype=dtype,
                                    device=device).reshape(-1)
            if bc.pre_kind == "ea_batch" and bc.post_kind == "node":
                v = v.reshape(-1)
            if bc.weights is not None:
                W = conn_const[str(bc.index)]["W"]
                if bc.full_weights:  # neuron->neuron currents (solver_weights)
                    v = (ein("knm,km->kn", W, v) if W.ndim == 3
                         else matmul(W, v))
                elif W.ndim == 3:  # batched input transforms (k, dim, s)
                    v = ein("kds,s->kd", W, v)
                else:
                    v = matmul(W, v)
            elif bc.scalar_weight != 1.0:
                v = bc.scalar_weight * v
            return v

        def conn_output(bc: BuiltConnection):
            if bc.synapse is not None:
                return filters[bc.filt_index]
            return current_value(bc)

        def zeros(shape):
            # made from the state, so under torch.func.vmap the buffer is
            # batched like the values added into it in place
            return step_no.new_zeros(shape, dtype=dtype)

        def add_current(J, bc, v, be):
            """J of a split group plus a neuron-current connection's
            whole value ``v``: the rank's neurons (or element) of it."""
            ga, (lo, hi) = gax[be.index], span[be.index]
            nl = be.n - be.n_pad
            if not (bc.full_weights or be.n_pad == 0):
                # phantom neurons get an exact zero
                v = v.reshape(-1, nl)
                v = torch.cat([v, zeros((v.shape[0], be.n - nl))], 1)
            e = bc.post_elem_index
            if e is not None:
                v = v.reshape(be.n)
                if ga == 1:
                    J[e] += v[lo:hi]
                elif lo <= e < hi:
                    J[e - lo] += v
                return J
            full = (be.k, be.n) if be.batched else (be.n,)
            return J + v.reshape(full).narrow(ga, lo, hi - lo)

        def row_shard(hk, params):
            """(first global row, shard handle) of the row-split tables of
            hoisted entry ``hk``, or None when this step holds them
            whole."""
            if shard is None or hk not in row_tables:
                return None
            name = row_tables[hk][0]
            m = params["hoisted"][hk][name].shape[0]
            if m == np.shape(model.hoisted[hk][name])[0]:
                return None
            return shard.rank * m, shard

        def gather_node_input(node):
            if shard is not None:
                prefetch([bc for bc in node_in.get(id(node), [])
                          if bc.synapse is None])
            x = zeros((node.size_in,))
            for bc in node_in.get(id(node), []):
                v = conn_output(bc)
                if bc.post_indices is not None:
                    x = add_at(x, bc, v)
                else:
                    x = x + v
            return x

        def gather_ens_input(be):
            shape = (be.k, be.dim) if be.batched else (be.dim,)
            if be.index in _tiled_inputs:
                return torch.cat(
                    [conn_output(bc).reshape((bc.ea_rows[1],) + shape[1:])
                     for bc in _tiled_inputs[be.index]], dim=0)
            x = zeros(shape)
            for bc in ens_in.get(be.index, []):
                if bc.index in row_local:     # added to the rank's rows
                    continue
                v = conn_output(bc)
                if bc.post_kind == "ea_batch":
                    if bc.ea_rows is not None:   # fused-EA member rows
                        off, kk = bc.ea_rows
                        x[off:off + kk] += v.reshape((kk,) + shape[1:])
                    else:
                        x = x + v.reshape(shape)
                elif bc.post_kind == "ea_elem":
                    if bc.post_indices is not None:
                        x = add_at(x, bc, v, row=bc.post_elem_index)
                    else:
                        x[bc.post_elem_index] += v
                else:  # ens
                    if bc.post_indices is not None:
                        x = add_at(x, bc, v)
                    else:
                        x = x + v
            return x

        # ---- same-step topological evaluation -----------------------------
        for kind, obj in model.topo_units:
            if kind == "node":
                info = model.node_info[id(obj)]
                nk = info["kind"]
                if nk == "tabulated":
                    sig_node[id(obj)] = xs[input_index[id(obj)]]
                elif nk == "const":
                    sig_node[id(obj)] = node_const[id(obj)]
                elif nk == "jnp_func":
                    x = gather_node_input(obj)
                    hk = info.get("hoisted_key")
                    slot = info.get("state_slot")
                    rows = row_shard(hk, params)
                    if rows is not None:
                        vsa.set_row_shard(rows)
                    if slot is not None:
                        # stateful node: f(t, x, s, consts=None)->(out, s')
                        kw = ({"consts": params["hoisted"][hk]}
                              if hk is not None else {})
                        out, ns = obj.output(t, x, node_states[slot], **kw)
                        new_node_states[slot] = torch.as_tensor(
                            ns, dtype=torch.float32, device=device)
                    elif hk is not None:
                        out = obj.output(t, x,
                                         consts=params["hoisted"][hk])
                    elif obj.size_in > 0:
                        out = obj.output(t, x)
                    else:
                        out = obj.output(t)
                    if rows is not None:
                        vsa.set_row_shard(None)
                    sig_node[id(obj)] = torch.as_tensor(
                        out, dtype=dtype, device=device).reshape(-1)
                else:  # passthrough
                    sig_node[id(obj)] = gather_node_input(obj)
            else:  # ensemble group
                be = obj
                p = enc_params[be.index]
                E = (learned[f"voja_{be.voja_conn_index}"]
                     if be.voja_conn_index is not None
                     else p["scaled_encoders"])
                ga = gax.get(be.index)
                if shard is not None:
                    prefetch([bc for bc in ens_in.get(be.index, [])
                              + ens_cur.get(be.index, [])
                              if bc.synapse is None])
                x = gather_ens_input(be)
                if ga == 0 and be.batched:    # the rank's rows
                    lo, hi = span[be.index]
                    x = x[lo:hi]
                    for bc in ens_in.get(be.index, []):
                        if bc.index in row_local:
                            x = x + conn_output(bc).reshape(x.shape)
                if be.batched:
                    J = ein("knd,kd->kn", E, x) + p["bias"]
                else:
                    J = matmul(E, x) + p["bias"]
                for bc in ens_cur.get(be.index, []):
                    v = conn_output(bc)
                    nl = be.n - be.n_pad
                    if ga is not None:
                        J = add_current(J, bc, v, be)
                    elif bc.full_weights or be.n_pad == 0:
                        if bc.post_elem_index is not None:  # fused element
                            J[bc.post_elem_index] += v
                        else:
                            J = J + v.reshape(J.shape)
                    elif bc.post_elem_index is not None:
                        J[bc.post_elem_index, :nl] += v
                    else:
                        J[..., :nl] += v.reshape(J.shape[:-1] + (nl,))
                ns, out = be.neuron_type.step(new_neurons[be.index], J, dt)
                new_neurons[be.index] = ns
                sig_act[be.index] = out

        def split_probe(bp):
            """The lazy value of a probe of a split group's decode or
            neurons, or None."""
            tg = bp.target
            if bp.kind not in ("ens_decoded", "activities", "voltage") \
                    or gax.get(getattr(tg, "index", None)) is None:
                return None
            if bp.kind == "ens_decoded":
                act = sig_act[tg.index]
                D = probe_const[str(bp.index)]["D"]
                if bp.elem_index is None:
                    return _Lazy(_Cell(matmul(act, D)))
                return _Lazy(_Cell(elem_part(act, bp.elem_index, D, tg)))
            src = (sig_act[tg.index] if bp.kind == "activities"
                   else new_neurons[tg.index]["voltage"])

            def view(v):
                if bp.elem_index is not None:
                    v = v[bp.elem_index]
                return v[..., :tg.n - tg.n_pad] if tg.n_pad else v
            return _Lazy(gathered((bp.kind, tg.index), src, tg), view)

        def whole_learned(bc, tree):
            """A learned leaf whole (gathered when this rank holds rows)."""
            x = tree[bc.learned_slot]
            be = _rule_group(bc)
            if be is None or gax.get(be.index) is None:
                return x
            lo, hi = span[be.index]
            part = zeros((be.n,) + tuple(x.shape[1:]))
            part[lo:hi] = x
            return _resolve(shard, [_Lazy(_Cell(part))])[0]

        # ---- filter updates ----------------------------------------------
        new_filters = list(filters)

        def update_filter(fi, u):
            a, b = filt_coeffs[fi]
            if fi in cascade:  # Alpha: first stage feeds the output stage
                h = cascade[fi]
                ah, bh = filt_coeffs[h]
                u = ah * filters[h] + bh * u
                new_filters[h] = u
            new_filters[fi] = a * filters[fi] + b * u

        if shard is not None:
            # one bucket: the decodes no later unit of this step reads (the
            # filter inputs, the Voja keys, unfiltered PES errors) and the
            # probes of split groups
            for bp in model.probes:
                lazy = split_probe(bp)
                if lazy is not None:
                    probe_memo[bp.index] = lazy
            prefetch([bc for bc in model.connections
                      if bc.filt_index is not None or bc.voja_rule is not None
                      ] + [model.connections[rci] for bc in model.connections
                           if bc.pes_rule is not None
                           for rci in bc.rule_target_conns
                           if model.connections[rci].synapse is None],
                     extra=probe_memo)

        for bc in model.connections:
            if bc.filt_index is not None:
                update_filter(bc.filt_index, current_value(bc))
            if bc.pes_act_filt_index is not None:
                src = (sig_act[bc.post.index] if bc.voja_rule is not None
                       else sig_act[bc.pre.index])
                update_filter(bc.pes_act_filt_index, src)

        # ---- learning updates --------------------------------------------
        new_learned = dict(learned)
        for bc in model.connections:
            if bc.pes_rule is not None:
                err = torch.zeros((bc.decoders.shape[-1]
                                   if bc.decoders is not None else 0,),
                                  dtype=dtype, device=device)
                for rci in bc.rule_target_conns:
                    err = err + conn_output(model.connections[rci])
                acts = (new_filters[bc.pes_act_filt_index]
                        if bc.pes_act_filt_index is not None
                        else sig_act[bc.pre.index])
                new_learned[bc.learned_slot] = learning_ops.pes_update(
                    learned[bc.learned_slot], acts, err,
                    params["hyper"]["lr"][bc.learned_slot], dt,
                    n_neurons=bc.pre.n - bc.pre.n_pad)
            elif bc.voja_rule is not None:
                gate = torch.zeros((1,), dtype=dtype, device=device)
                for rci in bc.rule_target_conns:
                    gate = gate + conn_output(model.connections[rci])
                learning_signal = 1.0 + gate[0]
                be = bc.post
                acts = (new_filters[bc.pes_act_filt_index]
                        if bc.pes_act_filt_index is not None
                        else sig_act[be.index])
                pre_v = current_value(bc)
                scale = enc_params[be.index]["gain"] / be.radius
                new_learned[bc.learned_slot] = learning_ops.voja_update(
                    learned[bc.learned_slot], acts, pre_v, learning_signal,
                    scale, params["hyper"]["lr"][bc.learned_slot], dt)

        # ---- probes -------------------------------------------------------
        emits = {}
        for bp in model.probes:
            if bp.index in probe_memo:
                v = probe_memo[bp.index]
            elif bp.kind == "node":
                v = sig_node[id(bp.target)]
            elif bp.kind == "ens_decoded":
                act = sig_act[bp.target.index]
                if bp.elem_index is not None:
                    act = act[bp.elem_index]
                v = matmul(act, probe_const[str(bp.index)]["D"])
            elif bp.kind == "activities":
                v = sig_act[bp.target.index]
                if bp.elem_index is not None:
                    v = v[bp.elem_index]
                if bp.target.n_pad:
                    v = v[..., :bp.target.n - bp.target.n_pad]
            elif bp.kind == "voltage":
                v = new_neurons[bp.target.index]["voltage"]
                if bp.elem_index is not None:
                    v = v[bp.elem_index]
                if bp.target.n_pad:
                    v = v[..., :bp.target.n - bp.target.n_pad]
            elif bp.kind == "weights":
                D = (whole_learned(bp.target, new_learned)
                     if bp.target.learned_slot
                     else conn_const[str(bp.target.index)]["D"])
                if isinstance(D, QTensor):   # quantised static decoders
                    D = D.dequant()
                v = D.t() if D.ndim == 2 else D
            elif bp.kind == "scaled_encoders":
                v = whole_learned(bp.target, new_learned)
            else:
                raise TypeError(bp.kind)
            if bp.filt_index is not None:
                a, b = filt_coeffs[bp.filt_index]
                if bp.filt_index in cascade:
                    h = cascade[bp.filt_index]
                    ah, bh = filt_coeffs[h]
                    v = ah * new_filters[h] + bh * v
                    new_filters[h] = v
                v = a * new_filters[bp.filt_index] + b * v
                new_filters[bp.filt_index] = v
            if not bp.sparse:
                emits[bp.index] = v

        new_state = {
            "step": step_no + 1,
            "neurons": new_neurons,
            "filters": new_filters,
            "learned": new_learned,
            "nodes": new_node_states,
        }
        return new_state, emits

    return step


def sparse_probe_value(model: Model, state, bp: BuiltProbe) -> np.ndarray:
    """Host-side read of a sparse (weights / scaled_encoders) probe from the
    state at a segment boundary: a copy, never a view of the live state."""
    def host(x):
        if torch.is_tensor(x):
            x = x.detach().cpu()
        return np.array(x, dtype=np.float32)

    if bp.kind == "weights":
        D = host(state["learned"][bp.target.learned_slot]
                 if bp.target.learned_slot else bp.target.decoders)
        return D.T if D.ndim == 2 else D
    if bp.kind == "scaled_encoders":
        return host(state["learned"][bp.target.learned_slot])
    raise TypeError(bp.kind)
