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

from typing import Dict

import numpy as np
import torch

from ..ops import learning as learning_ops
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


def make_step_fn(model: Model, dtype=torch.float32, matmul_dtype=None, *,
                 device):
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
    """
    device = torch.device(device)
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
            if bc.pre_kind == "neurons":
                nl = bc.pre.n - bc.pre.n_pad
                if bc.ea_elem_index is not None:  # fused-group element
                    v = act[bc.ea_elem_index]
                    return v if (bc.full_weights or bc.pre.n_pad == 0) \
                        else v[:nl]
                if bc.full_weights or bc.pre.n_pad == 0:
                    return act.reshape(-1)
                return act[..., :nl].reshape(-1)
            if bc.pre_kind == "ea_neurons":
                if bc.ea_rows is not None:
                    off, kk = bc.ea_rows
                    return act[off:off + kk]
                return act              # (k, n) raw activities
            raise TypeError(bc.pre_kind)

        def current_value(bc: BuiltConnection):
            v = pre_value(bc)
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

        def gather_node_input(node):
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
                x = gather_ens_input(be)
                if be.batched:
                    J = ein("knd,kd->kn", E, x) + p["bias"]
                else:
                    J = matmul(E, x) + p["bias"]
                for bc in ens_cur.get(be.index, []):
                    v = conn_output(bc)
                    nl = be.n - be.n_pad
                    if bc.full_weights or be.n_pad == 0:
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
            if bp.kind == "node":
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
                D = (new_learned[bp.target.learned_slot]
                     if bp.target.learned_slot
                     else conn_const[str(bp.target.index)]["D"])
                if isinstance(D, QTensor):   # quantised static decoders
                    D = D.dequant()
                v = D.t() if D.ndim == 2 else D
            elif bp.kind == "scaled_encoders":
                v = new_learned[bp.target.learned_slot]
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
