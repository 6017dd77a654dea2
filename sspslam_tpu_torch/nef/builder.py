"""Build a declarative Network into parameter arrays and a step plan.

Port of :mod:`sspslam_tpu.nef.builder`: the replacement for nengo's build
machinery.  Gain/bias computation, encoder and eval-point sampling, decoder
solving, EnsembleArray fusion, phantom padding, filter and learned slots
and the topological order of same-step units all happen here, on the host
in NumPy, with the JAX package's ``master`` / ``obj_rng`` seed streams — so
a network built from one seed has bitwise-equal encoders, gains, biases and
eval points in both packages.

The one device-dependent step is the decoder solve of large ensembles
(:mod:`.solvers`), which runs in float32 torch on the ``device`` passed to
:func:`build` and leaves those decoders there as tensors.
:mod:`.executor` steps a built :class:`Model`.

Spans (``utils.profiling``, recorded only while tracing): ``build.ensembles``
around the draws of every ensemble's parameters, ``build.solve`` around
each decoder solve (host or device), with the counter ``build.solves``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import synapses as synapse_ops
from ..ops.neurons import LIF, NeuronType
from ..utils import profiling
from .distributions import sample_dist, UniformHypersphere
from .graph import (BatchedConnection, Connection, EAElement, Ensemble,
                    EnsembleArray, LearningRule, Network, Neurons, Node,
                    ObjView, PES, Probe, Voja)
from .solvers import (DEVICE_SOLVE_MIN_BATCH_ELEMS, DEVICE_SOLVE_MIN_NEURONS,
                      lstsq_l2, lstsq_l2_batched,
                      solve_decoders_batched_on_device,
                      solve_decoders_on_device)

__all__ = ["Model", "build"]


def default_n_eval_points(n_neurons: int, dimensions: int) -> int:
    return max(int(np.clip(500 * dimensions, 750, 2500)), 2 * n_neurons)


def _eval_points_of(spec, n_eval_points, n, d, radius, rng):
    """Resolve an ensemble's eval points (nengo semantics: BOTH
    distribution samples and explicit (P, d) arrays are scaled by radius —
    nengo's ``gen_eval_points`` with its default ``scale_eval_points=True``
    multiplies after sampling/validation, so explicit points are given in
    the unit-radius convention)."""
    from .distributions import Distribution
    if spec is not None and not isinstance(spec, Distribution):
        arr = np.asarray(spec, dtype=np.float64)
        if arr.ndim == 2:
            assert arr.shape[1] == d, \
                f"eval_points shape {arr.shape} does not match dim {d}"
            return arr * radius
    n_ep = n_eval_points or default_n_eval_points(n, d)
    return sample_dist(spec, n_ep, d, rng=rng) * radius


# ---------------------------------------------------------------------------
# Built structures
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BuiltEnsemble:
    obj: Any                      # Ensemble or EnsembleArray
    index: int
    batched: bool
    k: int
    n: int
    dim: int
    radius: float
    neuron_type: NeuronType
    gain: np.ndarray              # (n,) or (k, n)
    bias: np.ndarray
    encoders: np.ndarray          # (n, dim) or (k, n, dim) unit rows
    scaled_encoders: np.ndarray   # encoders * gain / radius
    eval_points: np.ndarray       # (P, dim) in represented space
    #: phantom (silent) neurons appended to the neuron axis so it divides a
    #: model-parallel mesh: zero encoders, bias -1 — never spike, decoders
    #: solve to exact zero rows.  User-facing surfaces (neuron transforms,
    #: activity probes) address the LOGICAL n = n - n_pad.
    n_pad: int = 0
    voja_conn_index: Optional[int] = None  # encoders live in carry if set
    _acts_cache: Optional[np.ndarray] = None

    def activities_at_eval(self) -> np.ndarray:
        """Static rates at eval points: (P, n) or (k, P, n).

        float32 throughout — matching the precision the reference's
        accelerated backend (nengo_ocl) builds with; the normal-equation
        solve accumulates in float64."""
        if self._acts_cache is None:
            ep = self.eval_points.astype(np.float32)
            if self.batched:
                Et = np.ascontiguousarray(
                    self.scaled_encoders.transpose(0, 2, 1), dtype=np.float32)
                # fused groups carry per-element eval points (k, P, dim)
                epb = ep if ep.ndim == 3 else ep[None]
                J = epb @ Et + self.bias[:, None, :].astype(np.float32)
            else:
                Et = np.ascontiguousarray(self.scaled_encoders.T,
                                          dtype=np.float32)
                J = ep @ Et + self.bias[None, :].astype(np.float32)
            self._acts_cache = self.neuron_type.rates_np(J).astype(np.float32)
        return self._acts_cache


@dataclasses.dataclass
class BuiltConnection:
    obj: Any
    index: int
    pre_kind: str       # node | ens | ea | ea_elem | neurons | ens_view | ea_out
    post_kind: str      # ens | ea | ea_elem | node | neurons | pes | voja
    pre: Any = None     # resolved pre object (Node / BuiltEnsemble / ...)
    post: Any = None
    pre_indices: Optional[np.ndarray] = None
    post_indices: Optional[np.ndarray] = None
    ea_elem_index: Optional[int] = None       # pre element index
    post_elem_index: Optional[int] = None
    weights: Optional[np.ndarray] = None      # (post_size, pre_size) or None
    scalar_weight: float = 1.0
    decoders: Optional[np.ndarray] = None     # (n, d) or (k, n, d)
    jnp_function: Optional[Callable] = None   # for node pre
    synapse: Any = None
    filt_index: Optional[int] = None          # filter state slot
    filt_shape: Optional[Tuple[int, ...]] = None
    learned_slot: Optional[str] = None        # key into carry['learned']
    # (row0, k) slice of a FUSED EnsembleArray group this connection touches
    # (None when the endpoint owns the whole batched group)
    ea_rows: Optional[Tuple[int, int]] = None
    pes_rule: Optional[PES] = None
    voja_rule: Optional[Voja] = None
    pes_act_filt_index: Optional[int] = None
    rule_target_conns: List[int] = dataclasses.field(default_factory=list)
    # solver_weights=True lowering: ``weights`` holds the FULL neuron->neuron
    # matrix ((n_post, n_pre) or batched (k, n_post, n_pre)) applied directly
    # to pre activities and injected as post input current (matching nengo's
    # ``LstsqL2(weights=True)``, reference pathintegration.py:180-185).
    full_weights: bool = False


@dataclasses.dataclass
class BuiltProbe:
    obj: Probe
    index: int
    kind: str            # node | ens_decoded | activities | weights | scaled_encoders | voltage
    target: Any = None
    decoders: Optional[np.ndarray] = None
    synapse: Any = None
    filt_index: Optional[int] = None
    shape: Tuple[int, ...] = ()
    period_steps: int = 1
    sparse: bool = False
    elem_index: Optional[int] = None   # element within a fused batched group


class Model:
    """The compiled plan plus parameter arrays; owns ``make_step``."""

    def __init__(self, network: Network, dt: float, seed: Optional[int]):
        self.network = network
        self.dt = float(dt)
        self.seed = seed
        self.ensembles: List[BuiltEnsemble] = []
        self.connections: List[BuiltConnection] = []
        self.probes: List[BuiltProbe] = []
        self.node_info: Dict[int, dict] = {}   # id(node) -> info
        self.filter_specs: List[Tuple[Tuple[int, ...], float, float]] = []
        # two-stage (Alpha) synapses: output filter slot -> hidden first-stage
        # slot; executors chain the two one-pole updates per step
        self.filter_cascade: Dict[int, int] = {}
        self.topo_units: List[Tuple[str, Any]] = []
        self.learned_init: Dict[str, np.ndarray] = {}
        # stateful jnp nodes: slot -> initial state array.  A node function
        # with a ``state_init`` attribute has signature
        # ``f(t, x, state, consts=None) -> (out, new_state)`` and its state
        # becomes a carry leaf (state["nodes"][slot]) — in-step latches,
        # timers and controllers without host round trips
        self.node_state_init: Dict[str, np.ndarray] = {}
        # params-pytree contributions hoisted out of jnp-node closures
        # (e.g. the clean-up sample bank) — traced, not baked as constants
        self.hoisted: Dict[str, dict] = {}
        self.input_nodes: List[Node] = []      # tabulated nodes, in order
        self.dtype = torch.float32

    # -- carry construction -------------------------------------------------
    def initial_state(self):
        """Host-side zero carry (NumPy arrays)."""
        neurons = []
        for be in self.ensembles:
            shape = (be.k, be.n) if be.batched else (be.n,)
            neurons.append(be.neuron_type.init_state(shape, np.float32))
        filters = [np.zeros(shape, np.float32)
                   for shape, _, _ in self.filter_specs]
        # initial learned weights the solver left on the device come back
        # to the host with the rest of the carry
        learned = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                 else v, np.float32)
                   for k, v in self.learned_init.items()}
        return {
            "step": np.zeros((), np.int32),
            "neurons": neurons,
            "filters": filters,
            "learned": learned,
            "nodes": {k: np.asarray(v, np.float32)
                      for k, v in self.node_state_init.items()},
        }


# ---------------------------------------------------------------------------
# build()
# ---------------------------------------------------------------------------

def build(network: Network, dt: float = 0.001, seed: Optional[int] = None,
          default_neuron_type: Optional[NeuronType] = None,
          fuse_ensembles: bool = True, pad_batched_to: int = 1, *,
          device) -> Model:
    """``fuse_ensembles``: merge same-shaped single ensembles (same n, dim,
    radius, neuron type; no Voja-learned encoders, not pre of a PES
    connection) into ONE batched group executed as a single einsum + neuron
    update per step — an op-count optimisation with bitwise-identical
    parameters (each element keeps its own seeded draws).

    ``pad_batched_to``: pad every batched group's element axis up to a
    multiple of this (a model-parallel shard count) with PHANTOM rows —
    zero encoders/decoders, bias -1, so they never spike and contribute
    exact zeros — making the leading axis divisible by the shard count.

    ``device``: where the decoder solves of large ensembles run (see
    :mod:`.solvers`); those decoders are returned as tensors on it."""
    model = Model(network, dt, seed)
    master = np.random.default_rng(seed if seed is not None else network.seed)
    default_nt = default_neuron_type or LIF()

    ens_list, node_list, conn_list, probe_list, ea_list = network.all_objects()

    # EA prototype ensembles and EA i/o nodes are built specially
    ea_protos = {id(ea._proto) for ea in ea_list}
    ea_io_nodes = {}
    for ea in ea_list:
        ea_io_nodes[id(ea.input)] = ("ea_input", ea)
        ea_io_nodes[id(ea.output)] = ("ea_output", ea)
        for name, (fn, od, node, reg) in ea._outputs.items():
            ea_io_nodes[id(node)] = ("ea_func_output", ea)

    # ---- build ensembles --------------------------------------------------
    built_by_obj: Dict[int, BuiltEnsemble] = {}

    def obj_rng(obj):
        if getattr(obj, "seed", None) is not None:
            return np.random.default_rng(obj.seed)
        return np.random.default_rng(master.integers(2**31))

    def build_single(ens: Ensemble, idx: int) -> BuiltEnsemble:
        rng = obj_rng(ens)
        nt = ens.neuron_type or default_nt
        n, d = ens.n_neurons, ens.dimensions
        max_rates = sample_dist(ens.max_rates, n, rng=rng)
        intercepts = sample_dist(ens.intercepts, n, rng=rng)
        gain, bias = nt.gain_bias(max_rates, intercepts)
        enc_spec = ens.encoders
        from .graph import Default as _D
        if enc_spec is _D or enc_spec is None:
            enc = UniformHypersphere(surface=True).sample(n, d, rng=rng)
        else:
            enc = np.array(sample_dist(enc_spec, n, d, rng=rng), dtype=np.float64)
            if ens.normalize_encoders:
                enc = enc / np.maximum(
                    np.linalg.norm(enc, axis=1, keepdims=True), 1e-12)
        ep = _eval_points_of(ens.eval_points, ens.n_eval_points, n, d,
                             ens.radius, rng)
        scaled = enc * (gain / ens.radius)[:, None]
        n_pad = 0
        if pad_batched_to > 1 and n % pad_batched_to:
            # silent phantom neurons: the axis divides the mesh, decoders
            # solve to zero rows, learning leaves the rows at zero
            n_pad = pad_batched_to - n % pad_batched_to
            gain = np.concatenate([gain, np.zeros(n_pad)])
            bias = np.concatenate([bias, np.full(n_pad, -1.0)])
            enc = np.concatenate([enc, np.zeros((n_pad, d))])
            scaled = np.concatenate([scaled, np.zeros((n_pad, d))])
            n = n + n_pad
        return BuiltEnsemble(ens, idx, False, 1, n, d, ens.radius, nt,
                             gain, bias, enc, scaled, ep, n_pad=n_pad)

    def build_array(ea: EnsembleArray, idx: int) -> BuiltEnsemble:
        proto = ea._proto
        rng = obj_rng(ea)
        nt = proto.neuron_type or default_nt
        k, n, d = ea.n_ensembles, ea.n_neurons_per, ea.ens_dimensions
        from .graph import Default as _D
        gains, biases, encs = [], [], []
        for j in range(k):
            max_rates = sample_dist(proto.max_rates, n, rng=rng)
            intercepts = sample_dist(proto.intercepts, n, rng=rng)
            g, b = nt.gain_bias(max_rates, intercepts)
            if proto.encoders is _D or proto.encoders is None:
                e = UniformHypersphere(surface=True).sample(n, d, rng=rng)
            else:
                e = np.array(sample_dist(proto.encoders, n, d, rng=rng))
                e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
            gains.append(g); biases.append(b); encs.append(e)
        gain = np.stack(gains); bias = np.stack(biases); enc = np.stack(encs)
        ep = _eval_points_of(proto.eval_points, proto.n_eval_points, n, d,
                             ea.radius, rng)
        scaled = enc * (gain / ea.radius)[..., None]
        return BuiltEnsemble(ea, idx, True, k, n, d, ea.radius, nt,
                             gain, bias, enc, scaled, ep)

    # element index within a fused batched group, keyed by id(Ensemble)
    fused_elem: Dict[int, int] = {}

    # fusion exclusions: Voja-learned encoders live in the carry per
    # ensemble; PES pre-activities are filtered per ensemble
    voja_posts, pes_pres = set(), set()
    for conn in conn_list:
        lrt = getattr(conn, "learning_rule_type", None)
        if isinstance(lrt, Voja):
            post = conn.post.obj if isinstance(conn.post, ObjView) else conn.post
            voja_posts.add(id(post))
        if isinstance(lrt, PES):
            pre = conn.pre.obj if isinstance(conn.pre, ObjView) else conn.pre
            pes_pres.add(id(pre))

    # build every single in declaration order (preserves each ensemble's
    # seeded parameter draws exactly), then group same-shaped ones; the
    # arrays draw after them
    with profiling.span("build.ensembles"):
        singles = [(ens, build_single(ens, -1))
                   for ens in ens_list if id(ens) not in ea_protos]
        ea_builds = [(ea, build_array(ea, -1)) for ea in ea_list]
    groups: Dict[Any, list] = {}
    for ens, be in singles:
        fusable = (fuse_ensembles and id(ens) not in voja_posts
                   and id(ens) not in pes_pres)
        key = ((be.n, be.dim, float(be.radius), be.neuron_type,
                be.eval_points.shape[0])
               if fusable else ("solo", id(ens)))
        groups.setdefault(key, []).append((ens, be))

    for key, members in groups.items():
        if len(members) == 1:
            ens, be = members[0]
            be.index = len(model.ensembles)
            built_by_obj[id(ens)] = be
            model.ensembles.append(be)
            continue
        first = members[0][1]
        merged = BuiltEnsemble(
            obj=tuple(ens for ens, _ in members),
            index=len(model.ensembles), batched=True,
            k=len(members), n=first.n, dim=first.dim, radius=first.radius,
            neuron_type=first.neuron_type,
            gain=np.stack([b.gain for _, b in members]),
            bias=np.stack([b.bias for _, b in members]),
            encoders=np.stack([b.encoders for _, b in members]),
            scaled_encoders=np.stack([b.scaled_encoders
                                      for _, b in members]),
            # per-element eval points: (k, P, dim)
            eval_points=np.stack([b.eval_points for _, b in members]),
            n_pad=members[0][1].n_pad)
        for j, (ens, _) in enumerate(members):
            built_by_obj[id(ens)] = merged
            fused_elem[id(ens)] = j
        model.ensembles.append(merged)

    # ---- EnsembleArray fusion --------------------------------------------
    # Same-spec EnsembleArrays whose ONLY wiring is the implicit input/
    # output routes (e.g. the two (2d, n, 1) circular-convolution product
    # arrays in SLAMNetwork) merge into one batched group with row offsets:
    # one encode einsum + one neuron update + one decode einsum per step
    # instead of one set per array.  Arrays referenced per-element, by
    # Neurons views, or by BatchedConnections (the recurrent VCO bank) stay
    # solo — their wiring addresses individual rows/whole groups.
    ea_fuse_excluded = set()
    for conn in conn_list:
        if isinstance(conn, BatchedConnection):
            for end in (conn.pre, conn.post):
                if isinstance(end, EnsembleArray):
                    ea_fuse_excluded.add(id(end))
            continue
        for end in (conn.pre, conn.post):
            base = end.obj if isinstance(end, ObjView) else end
            if isinstance(base, EAElement):
                ea_fuse_excluded.add(id(base.ea))
            ens_of = getattr(base, "ensemble", None)
            if isinstance(ens_of, EAElement):
                ea_fuse_excluded.add(id(ens_of.ea))
        if conn.learning_rule_type is not None:
            for end in (conn.pre, conn.post):
                base = end.obj if isinstance(end, ObjView) else end
                if isinstance(base, EnsembleArray):
                    ea_fuse_excluded.add(id(base))
    for p in probe_list:
        base = p.target.obj if isinstance(p.target, ObjView) else p.target
        if isinstance(base, EAElement):
            ea_fuse_excluded.add(id(base.ea))
        ens_of = getattr(base, "ensemble", None)
        if isinstance(ens_of, EAElement):
            ea_fuse_excluded.add(id(ens_of.ea))

    #: per-EA row offset inside its (possibly merged) batched group, and the
    #: solve proxy carrying the EA's own eval points / params for decoder
    #: solving (identical draws to the unfused build)
    ea_row0: Dict[int, int] = {}
    ea_solve_proxy: Dict[int, BuiltEnsemble] = {}
    import os as _os
    _ea_fuse_on = _os.environ.get("SSPSLAM_FUSE_EA", "1") != "0"
    ea_groups: Dict[Any, list] = {}
    for ea, be in ea_builds:
        fusable = (fuse_ensembles and _ea_fuse_on
                   and id(ea) not in ea_fuse_excluded)
        key = ((be.n, be.dim, float(be.radius), be.neuron_type,
                be.eval_points.shape[0])
               if fusable else ("solo", id(ea)))
        ea_groups.setdefault(key, []).append((ea, be))
    for key, members in ea_groups.items():
        k_tot = sum(b.k for _, b in members)
        pad_rows = 0
        if pad_batched_to > 1 and k_tot % pad_batched_to:
            pad_rows = pad_batched_to - k_tot % pad_batched_to
        if len(members) == 1 and pad_rows == 0:
            ea, be = members[0]
            be.index = len(model.ensembles)
            built_by_obj[id(ea)] = be
            ea_row0[id(ea)] = 0
            ea_solve_proxy[id(ea)] = be
            model.ensembles.append(be)
            continue
        first = members[0][1]

        def cat(attr, pad_val=0.0):
            parts = [getattr(b, attr) for _, b in members]
            if pad_rows:
                parts.append(np.full((pad_rows,) + parts[0].shape[1:],
                                     pad_val, parts[0].dtype))
            return np.concatenate(parts)

        merged = BuiltEnsemble(
            obj=tuple(ea for ea, _ in members), index=len(model.ensembles),
            batched=True, k=k_tot + pad_rows,
            n=first.n, dim=first.dim, radius=first.radius,
            neuron_type=first.neuron_type,
            gain=cat("gain"),
            # phantom rows: bias -1 keeps every neuron model silent
            # (LIF J<1, ReLU J<0); zero encoders/decoders make their
            # contribution exactly zero
            bias=cat("bias", pad_val=-1.0),
            encoders=cat("encoders"),
            scaled_encoders=cat("scaled_encoders"),
            # per-element eval points so any direct solve on the merged
            # group addresses the right rows (routes solve via the proxy)
            eval_points=np.concatenate(
                [np.broadcast_to(b.eval_points,
                                 (b.k,) + b.eval_points.shape)
                 for _, b in members]
                + ([np.broadcast_to(first.eval_points,
                                    (pad_rows,) + first.eval_points.shape)]
                   if pad_rows else [])))
        off = 0
        for ea, b in members:
            built_by_obj[id(ea)] = merged
            ea_row0[id(ea)] = off
            ea_solve_proxy[id(ea)] = b
            off += b.k
        model.ensembles.append(merged)

    # ---- node info --------------------------------------------------------
    for node in node_list:
        info = {"node": node, "kind": None, "const": None}
        if id(node) in ea_io_nodes:
            role, ea = ea_io_nodes[id(node)]
            info["kind"] = "passthrough"  # wired via implicit connections below
        elif node.output is None:
            info["kind"] = "passthrough"
        elif callable(node.output):
            import inspect
            try:
                nparams = len(inspect.signature(node.output).parameters)
            except (TypeError, ValueError):
                nparams = 1
            if node.size_in > 0 or nparams >= 2:
                info["kind"] = "jnp_func"
                hc = getattr(node.output, "hoisted_consts", None)
                if hc:
                    key = f"h{len(model.hoisted)}"
                    info["hoisted_key"] = key
                    model.hoisted[key] = dict(hc)
                # optional pure-NumPy mirror of the node function
                info["np_func"] = getattr(node.output, "np_function", None)
                si = getattr(node.output, "state_init", None)
                if si is not None:
                    key = f"ns{len(model.node_state_init)}"
                    info["state_slot"] = key
                    model.node_state_init[key] = np.asarray(si, np.float32)
            else:
                info["kind"] = "tabulated"
            if node.size_out is None:
                if info["kind"] == "tabulated":
                    out = np.asarray(node.output(dt))
                else:
                    # learn the output size by calling the function once on
                    # host tensors
                    slot = info.get("state_slot")
                    hk = info.get("hoisted_key")
                    kw = ({"consts": model.hoisted[hk]}
                          if hk is not None else {})
                    x0 = torch.zeros(node.size_in)
                    if slot is not None:
                        out, _ns = node.output(
                            dt, x0,
                            torch.as_tensor(model.node_state_init[slot]),
                            **kw)
                    else:
                        out = node.output(dt, x0, **kw)
                    out = np.asarray(out)
                node.size_out = int(out.size)
        else:
            info["kind"] = "const"
            info["const"] = np.asarray(node.output, dtype=np.float64).reshape(-1)
            node.size_out = info["const"].size
        model.node_info[id(node)] = info
        if info["kind"] == "tabulated":
            model.input_nodes.append(node)

    # ---- implicit EA connections -----------------------------------------
    implicit_conns: List[Any] = []
    for ea in ea_list:
        be = built_by_obj[id(ea)]
        implicit_conns.append(("ea_input_route", ea.input, be, ea))
        implicit_conns.append(("ea_output_route", be, ea.output, None, 0.1,
                               ea))
        for name, (fn, od, node, reg) in ea._outputs.items():
            implicit_conns.append(("ea_output_route", be, node, fn, reg, ea))

    # ---- helpers for connection building ---------------------------------
    filter_specs = model.filter_specs

    def add_filter(shape, synapse) -> int:
        a, b, stages = synapse_ops.coefficients(synapse, dt)
        filter_specs.append((tuple(shape), a, b))
        idx = len(filter_specs) - 1
        if stages == 2:  # Alpha: cascade of two identical one-pole stages
            filter_specs.append((tuple(shape), a, b))
            out = len(filter_specs) - 1
            model.filter_cascade[out] = idx
            return out
        return idx

    def resolve_pre(pre):
        """-> (kind, resolved, indices, elem_index)"""
        if isinstance(pre, ObjView):
            base = pre.obj
            if isinstance(base, Node):
                return "node", base, pre.indices_for(base.size_out), None
            if isinstance(base, Ensemble):
                j = fused_elem.get(id(base))
                kind = "ea_elem" if j is not None else "ens_view"
                return (kind, built_by_obj[id(base)],
                        pre.indices_for(base.dimensions), j)
            if isinstance(base, EAElement):
                return ("ea_elem", built_by_obj[id(base.ea)],
                        pre.indices_for(base.dimensions),
                        base.index + ea_row0.get(id(base.ea), 0))
            raise TypeError(f"bad pre view base {base!r}")
        if isinstance(pre, Node):
            return "node", pre, None, None
        if isinstance(pre, Ensemble):
            j = fused_elem.get(id(pre))
            if j is not None:
                return "ea_elem", built_by_obj[id(pre)], None, j
            return "ens", built_by_obj[id(pre)], None, None
        if isinstance(pre, EnsembleArray):
            return "node", pre.output, None, None
        if isinstance(pre, EAElement):
            return ("ea_elem", built_by_obj[id(pre.ea)], None,
                    pre.index + ea_row0.get(id(pre.ea), 0))
        if isinstance(pre, Neurons):
            return ("neurons", built_by_obj[id(pre.ensemble)], None,
                    fused_elem.get(id(pre.ensemble)))
        raise TypeError(f"bad pre {pre!r}")

    def resolve_post(post):
        if isinstance(post, ObjView):
            base = post.obj
            if isinstance(base, Node):
                return "node", base, post.indices_for(base.size_in), None
            if isinstance(base, Ensemble):
                j = fused_elem.get(id(base))
                kind = "ea_elem" if j is not None else "ens"
                return (kind, built_by_obj[id(base)],
                        post.indices_for(base.dimensions), j)
            if isinstance(base, EAElement):
                return ("ea_elem", built_by_obj[id(base.ea)],
                        post.indices_for(base.dimensions),
                        base.index + ea_row0.get(id(base.ea), 0))
            raise TypeError(f"bad post view base {base!r}")
        if isinstance(post, Node):
            return "node", post, None, None
        if isinstance(post, Ensemble):
            j = fused_elem.get(id(post))
            if j is not None:
                return "ea_elem", built_by_obj[id(post)], None, j
            return "ens", built_by_obj[id(post)], None, None
        if isinstance(post, EnsembleArray):
            return "node", post.input, None, None
        if isinstance(post, EAElement):
            return ("ea_elem", built_by_obj[id(post.ea)], None,
                    post.index + ea_row0.get(id(post.ea), 0))
        if isinstance(post, Neurons):
            return ("neurons", built_by_obj[id(post.ensemble)], None,
                    fused_elem.get(id(post.ensemble)))
        if isinstance(post, LearningRule):
            kind = "pes" if isinstance(post.rule, PES) else "voja"
            return kind, post, None, None
        raise TypeError(f"bad post {post!r}")

    def pre_size(kind, pre, indices, elem_index):
        if kind == "node":
            s = pre.size_out
        elif kind in ("ens", "ens_view"):
            s = pre.dim
        elif kind == "ea_elem":
            s = pre.dim
        elif kind == "neurons":
            nl = pre.n - pre.n_pad
            if elem_index is not None:  # one element of a fused group
                return nl
            return pre.k * nl if pre.batched else nl
        else:
            raise TypeError(kind)
        return len(indices) if indices is not None else s

    def post_size(kind, post, indices, elem_index):
        if indices is not None:
            return len(indices)
        if kind == "node":
            return post.size_in
        if kind == "ens":
            return post.dim
        if kind == "ea_elem":
            return post.dim
        if kind == "neurons":
            nl = post.n - post.n_pad
            if elem_index is not None:  # one element of a fused group
                return nl
            return post.k * nl if post.batched else nl
        if kind == "pes":
            return post.size_in
        if kind == "voja":
            return 1
        raise TypeError(kind)

    def normalize_transform(transform, psize, prsize):
        if np.isscalar(transform):
            return None, float(transform)
        W = np.asarray(transform, dtype=np.float64)
        if W.ndim == 0:
            return None, float(W)
        if W.ndim == 1:
            W = np.diag(W) if W.size == psize == prsize else W.reshape(psize, prsize)
        assert W.shape == (psize, prsize), (
            f"transform shape {W.shape} != ({psize}, {prsize})")
        return W, 1.0

    _decoder_cache: Dict[tuple, np.ndarray] = {}

    def solve_decoders(be: BuiltEnsemble, function, reg, pre_indices=None,
                       targets_out_dim=None, eval_points=None):
        """Solve decoders for a (possibly batched) built ensemble. Cached so
        k per-element connections sharing a function solve one batched
        problem.  ``eval_points``: optional per-connection override
        (nengo `Connection(eval_points=...)` semantics) — solved at those
        points instead of the ensemble's."""
        key = (id(be), id(function) if function is not None else None, reg,
               tuple(pre_indices) if pre_indices is not None else None,
               id(eval_points) if eval_points is not None else None)
        if key in _decoder_cache:
            return _decoder_cache[key]
        with profiling.span("build.solve"):
            out = _solve_decoders_impl(be, function, reg, pre_indices,
                                       eval_points)
        if profiling.tracing_on():
            profiling.count("build.solves")
        _decoder_cache[key] = out
        return out

    def _eval_targets(ep, function):
        """targets for one (P, dim) eval-point block."""
        P = ep.shape[0]
        if function is None:
            return ep.copy()
        try:  # vectorised functions evaluate the whole batch at once
            batch = np.asarray(function(ep), dtype=np.float64)
            if batch.ndim == 2 and batch.shape[0] == P:
                return batch
        except (TypeError, ValueError, IndexError) as batch_exc:
            # probe one row before falling back: a function that ALSO
            # fails row-wise is buggy, not merely unvectorised — surface
            # the original error at the cause instead of a confusing
            # failure deep in the row loop
            try:
                np.atleast_1d(np.asarray(function(ep[0]), dtype=np.float64))
            except Exception:
                raise batch_exc
        return np.asarray(
            [np.atleast_1d(np.asarray(function(x), dtype=np.float64))
             for x in ep])

    def _solve_decoders_impl(be: BuiltEnsemble, function, reg,
                             pre_indices=None, eval_points=None):
        if eval_points is not None:
            # per-connection eval points: rates computed inline (the
            # ensemble's activity cache is for its own points).  Scaled by
            # the pre-ensemble radius, matching nengo's build_decoders →
            # gen_eval_points(scale_eval_points=True) semantics
            ep = np.asarray(eval_points, np.float64) * be.radius
            targets = _eval_targets(ep, function)
            if pre_indices is not None:
                targets = targets[..., pre_indices]
            epf = ep.astype(np.float32)
            if be.batched:
                Et = np.ascontiguousarray(
                    be.scaled_encoders.transpose(0, 2, 1), np.float32)
                J = epf[None] @ Et + be.bias[:, None, :].astype(np.float32)
                acts = be.neuron_type.rates_np(J).astype(np.float32)
                tb = np.broadcast_to(
                    targets, (be.k,) + targets.shape).copy()
                return lstsq_l2_batched(acts, tb, reg=reg)
            J = epf @ np.ascontiguousarray(be.scaled_encoders.T, np.float32) \
                + be.bias[None, :].astype(np.float32)
            acts = be.neuron_type.rates_np(J).astype(np.float32)
            return lstsq_l2(acts, targets, reg=reg)
        ep = be.eval_points  # (P, dim) — or (k, P, dim) for fused groups
        per_elem = be.batched and ep.ndim == 3
        P = ep.shape[1] if per_elem else ep.shape[0]
        if per_elem:
            targets = np.stack([_eval_targets(ep[j], function)
                                for j in range(be.k)])   # (k, P, d)
        else:
            targets = _eval_targets(ep, function)
        if pre_indices is not None:
            targets = targets[..., pre_indices]
        if not be.batched and be.n >= DEVICE_SOLVE_MIN_NEURONS:
            # large single ensembles: run the whole solve on the device
            return solve_decoders_on_device(
                be.neuron_type, be.scaled_encoders, be.bias, be.eval_points,
                targets, reg=reg, device=device)
        if (be.batched
                and be.k * P * be.n >= DEVICE_SOLVE_MIN_BATCH_ELEMS):
            # large EnsembleArrays (the VCO bank): rate tabulation + batched
            # normal equations dominate host build time — run on device
            return solve_decoders_batched_on_device(
                be.neuron_type, be.scaled_encoders, be.bias, be.eval_points,
                targets, reg=reg, device=device)
        acts = be.activities_at_eval()
        if be.batched:
            return lstsq_l2_batched(acts, targets, reg=reg)  # (k, n, d)
        return lstsq_l2(acts, targets, reg=reg)              # (n, d)

    # ---- build explicit connections --------------------------------------
    rule_map: Dict[int, BuiltConnection] = {}  # id(LearningRule) -> bc

    def make_builtconn(conn) -> BuiltConnection:
        bc = BuiltConnection(conn, len(model.connections), "", "")
        pk, pre, pidx, pelem = resolve_pre(conn.pre)
        sk, post, sidx, selem = resolve_post(conn.post)
        bc.pre_kind, bc.pre, bc.pre_indices, bc.ea_elem_index = pk, pre, pidx, pelem
        bc.post_kind, bc.post, bc.post_indices, bc.post_elem_index = sk, post, sidx, selem
        prsize = pre_size(pk, pre, pidx, pelem)
        psize = post_size(sk, post, sidx, selem)
        bc.weights, bc.scalar_weight = normalize_transform(conn.transform, psize, prsize)
        bc.synapse = conn.synapse

        if pk in ("ens", "ens_view", "ea_elem"):
            # decoded connection: solve
            if pk == "ea_elem":
                dec_all = solve_decoders(bc.pre, conn.function, conn.solver_reg,
                                         pre_indices=pidx,
                                         eval_points=conn.eval_points)
                bc.decoders = dec_all[pelem]  # (n, d)
            else:
                bc.decoders = solve_decoders(bc.pre, conn.function, conn.solver_reg,
                                             pre_indices=pidx,
                                             eval_points=conn.eval_points)
            if conn.learning_rule_type is not None and isinstance(
                    conn.learning_rule_type, PES):
                bc.pes_rule = conn.learning_rule_type
                slot = f"pes_{bc.index}"
                bc.learned_slot = slot
                model.learned_init[slot] = bc.decoders
                if bc.pes_rule.pre_synapse is not None:
                    nshape = (bc.pre.n,) if not bc.pre.batched else (bc.pre.k, bc.pre.n)
                    bc.pes_act_filt_index = add_filter(nshape, bc.pes_rule.pre_synapse)
                rule_map[id(conn.learning_rule)] = bc
            if getattr(conn, "solver_weights", False):
                # Full-weight solve (nengo LstsqL2(weights=True) equivalent,
                # reference pathintegration.py:180-185): fold transform and
                # post encoders into one neuron->neuron matrix; the decoded
                # signal never exists at run time.  ``ea_elem`` endpoints are
                # elements of fused batched groups — currents inject into the
                # element's row.
                assert sk in ("ens", "ea_elem"), \
                    "solver_weights=True requires a single-Ensemble post"
                assert sk == "ea_elem" or not post.batched
                assert conn.learning_rule_type is None, \
                    "solver_weights=True is incompatible with learning rules"
                assert post.voja_conn_index is None, \
                    "solver_weights=True post cannot have Voja-learned encoders"
                assert sidx is None and bc.pre_indices is None
                D = _host64(bc.decoders)                         # (n_pre, d)
                if bc.weights is not None:
                    D = D @ np.asarray(bc.weights, np.float64).T  # -> post dim
                elif bc.scalar_weight != 1.0:
                    D = D * bc.scalar_weight
                E_post = np.asarray(post.scaled_encoders, np.float64)
                if sk == "ea_elem":
                    E_post = E_post[selem]
                Wfull = E_post @ D.T
                bc.weights = Wfull                               # (n_post, n_pre)
                bc.scalar_weight = 1.0
                bc.decoders = None
                bc.full_weights = True
                bc.pre_kind = "neurons"   # ea_elem_index selects a fused row
                bc.post_kind = "neurons"
                psize = post.n  # filtered signal is post input current
        elif pk == "node":
            if conn.function is not None:
                bc.jnp_function = conn.function
            if conn.learning_rule_type is not None and isinstance(
                    conn.learning_rule_type, Voja):
                bc.voja_rule = conn.learning_rule_type
                assert sk == "ens" and not post.batched, \
                    "Voja supported on node->Ensemble connections"
                slot = f"voja_{bc.index}"
                bc.learned_slot = slot
                model.learned_init[slot] = post.scaled_encoders
                post.voja_conn_index = bc.index
                if bc.voja_rule.post_synapse is not None:
                    # filtered post activities drive the encoder drift
                    bc.pes_act_filt_index = add_filter(
                        (post.n,), bc.voja_rule.post_synapse)
                rule_map[id(conn.learning_rule)] = bc

        if getattr(conn, "solver_weights", False) and not bc.full_weights:
            raise NotImplementedError(
                "solver_weights=True requires an Ensemble pre and a "
                f"single-Ensemble post (got {bc.pre_kind} -> {bc.post_kind})")
        if bc.synapse is not None:
            bc.filt_shape = (psize,)
            bc.filt_index = add_filter(bc.filt_shape, bc.synapse)
        return bc

    batched_conns: List[BuiltConnection] = []

    def make_batched(conn: BatchedConnection) -> BuiltConnection:
        bc = BuiltConnection(conn, len(model.connections), "", "")
        # post must be an EnsembleArray
        assert isinstance(conn.post, EnsembleArray)
        bpost = built_by_obj[id(conn.post)]
        bc.post, bc.post_kind = bpost, "ea_batch"
        if isinstance(conn.pre, EnsembleArray):
            bpre = built_by_obj[id(conn.pre)]
            assert bpre is bpost, "batched recurrent must be self-connection"
            bc.pre, bc.pre_kind = bpre, "ea_batch"
            # solve on the EA's own (unpadded) proxy build; phantom pad
            # rows get zero decoders
            bpre_solve = ea_solve_proxy.get(id(conn.pre), bpre)
            dec = solve_decoders(bpre_solve, conn.function, conn.solver_reg)
            # decoders from a device solve stay a tensor on that device
            on_device = torch.is_tensor(dec)
            if conn.element_mask is not None:
                mask = np.asarray(conn.element_mask)[:, None, None]
                if on_device:
                    mask = torch.as_tensor(mask, dtype=dec.dtype,
                                           device=dec.device)
                dec = dec * mask
            if int(dec.shape[0]) != bpost.k:   # padded group
                pad_rows = bpost.k - int(dec.shape[0])
                z_shape = (pad_rows,) + tuple(dec.shape[1:])
                if on_device:
                    dec = torch.cat([dec, dec.new_zeros(z_shape)])
                else:
                    dec = np.concatenate([dec, np.zeros(z_shape, dec.dtype)])
            if getattr(conn, "solver_weights", False):
                # batched full-weight solve: per element, fold post encoders
                # into an (n_post, n_pre) matrix; one big batched matmul per
                # step instead of decode+encode (reference
                # pathintegration.py:180-185 with weights=True).
                bc.weights = np.einsum(
                    "knd,kmd->knm",
                    np.asarray(bpost.scaled_encoders, np.float64),
                    _host64(dec))
                bc.full_weights = True
                bc.pre_kind = "ea_neurons"
                bc.post_kind = "neurons"
            else:
                bc.decoders = dec
        else:
            pk, pre, pidx, pelem = resolve_pre(conn.pre)
            assert pk == "node", "batched input connections take a node pre"
            bc.pre, bc.pre_kind, bc.pre_indices = pre, "node", pidx
            W = np.asarray(conn.transforms, dtype=np.float64)  # (k, dim, pre)
            assert W.ndim == 3 and W.shape[1] == bpost.dim
            assert W.shape[0] in (bpost.k, conn.post.n_ensembles)
            if conn.element_mask is not None:
                W = W * np.asarray(conn.element_mask)[:, None, None]
            if W.shape[0] != bpost.k:   # padded group: zero input rows
                W = np.concatenate(
                    [W, np.zeros((bpost.k - W.shape[0],) + W.shape[1:],
                                 W.dtype)])
            bc.weights = W
        bc.synapse = conn.synapse
        if bc.synapse is not None:
            bc.filt_shape = ((bpost.k, bpost.n) if bc.full_weights
                             else (bpost.k, bpost.dim))
            bc.filt_index = add_filter(bc.filt_shape, bc.synapse)
        return bc

    # EA implicit routes become BuiltConnections too
    for item in implicit_conns:
        if item[0] == "ea_input_route":
            _, in_node, be, ea = item
            bc = BuiltConnection(None, len(model.connections), "node", "ea_batch",
                                 pre=in_node, post=be)
            bc.synapse = None
            if ea_solve_proxy[id(ea)] is not be:   # fused group member
                bc.ea_rows = (ea_row0[id(ea)], ea.n_ensembles)
            model.connections.append(bc)
        else:
            _, be, out_node, fn, reg, ea = item
            bc = BuiltConnection(None, len(model.connections), "ea_batch", "node",
                                 pre=be, post=out_node)
            # solve on the EA's own proxy build: identical decoders to the
            # unfused model, sized (k_ea, n, od)
            bc.decoders = solve_decoders(ea_solve_proxy[id(ea)], fn, reg)
            bc.synapse = None
            if ea_solve_proxy[id(ea)] is not be:
                bc.ea_rows = (ea_row0[id(ea)], ea.n_ensembles)
            model.connections.append(bc)

    for conn in conn_list:
        if isinstance(conn, BatchedConnection):
            bc = make_batched(conn)
        else:
            bc = make_builtconn(conn)
        model.connections.append(bc)

    # attach rule-input connections (error signals / voja gates)
    for bc in model.connections:
        if bc.post_kind in ("pes", "voja"):
            target_bc = rule_map.get(id(bc.post))
            if target_bc is None:
                raise ValueError(f"connection {bc.obj} targets an unbuilt learning rule")
            target_bc.rule_target_conns.append(bc.index)

    # ---- probes -----------------------------------------------------------
    for p in probe_list:
        bp = BuiltProbe(p, len(model.probes), "")
        tgt = p.target
        if isinstance(tgt, (Connection,)) or (p.attr == "weights"):
            # find built conn
            bc = next(c for c in model.connections if c.obj is tgt)
            assert bc.learned_slot, "weights probe requires a learned connection"
            bp.kind, bp.target = "weights", bc
        elif isinstance(tgt, LearningRule):
            bc = rule_map[id(tgt)]
            if isinstance(tgt.rule, Voja):
                bp.kind, bp.target = "scaled_encoders", bc
            else:
                bp.kind, bp.target = "weights", bc
        elif isinstance(tgt, Neurons):
            be = built_by_obj[id(tgt.ensemble)]
            if p.attr == "voltage":
                # neuron membrane state (nengo `Probe(ens.neurons,
                # 'voltage')` parity); only stateful (spiking) neuron
                # models carry a voltage in the carry
                if not be.neuron_type.spiking:
                    raise ValueError(
                        f"voltage probe on non-spiking neuron type "
                        f"{type(be.neuron_type).__name__}")
                bp.kind, bp.target = "voltage", be
            else:
                bp.kind, bp.target = "activities", be
            bp.elem_index = fused_elem.get(id(tgt.ensemble))
        elif isinstance(tgt, Ensemble):
            if p.attr is not None:
                # silent-misparse guard: Probe(ens, "scaled_encoders")
                # would otherwise build a decoded-output probe
                raise ValueError(
                    f"unknown probe attr {p.attr!r} for an Ensemble "
                    "(decoded output takes no attr; probe "
                    "conn.learning_rule for 'scaled_encoders'/'weights', "
                    "ens.neurons for 'voltage'/activities)")
            be = built_by_obj[id(tgt)]
            bp.kind, bp.target = "ens_decoded", be
            j = fused_elem.get(id(tgt))
            bp.elem_index = j
            dec = solve_decoders(be, None, 0.1)
            bp.decoders = dec[j] if j is not None else dec
        elif isinstance(tgt, Node):
            bp.kind, bp.target = "node", tgt
        elif isinstance(tgt, EnsembleArray):
            bp.kind, bp.target = "node", tgt.output
        else:
            raise TypeError(f"cannot probe {tgt!r}")
        bp.synapse = p.synapse
        if p.synapse is not None:
            shape = _probe_shape(bp)
            bp.filt_index = add_filter(shape, p.synapse)
        bp.period_steps = (1 if p.sample_every is None
                           else max(1, int(round(p.sample_every / dt))))
        bp.shape = _probe_shape(bp)
        bp.sparse = bp.kind in ("weights", "scaled_encoders") and bp.period_steps > 1
        model.probes.append(bp)

    # ---- topological order of same-step units -----------------------------
    try:
        model.topo_units = _topo_sort(model)
    except RuntimeError:
        if fuse_ensembles:
            # fusing two ensembles that feed each other through an
            # instantaneous path makes the merged unit self-dependent; fall
            # back to the unfused build (correct, slightly more ops)
            return build(network, dt=dt, seed=seed,
                         default_neuron_type=default_neuron_type,
                         fuse_ensembles=False, device=device)
        raise
    return model


def _host64(x) -> np.ndarray:
    """A float64 host copy of a NumPy array or a tensor on any device."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _probe_shape(bp: BuiltProbe) -> Tuple[int, ...]:
    if bp.kind == "node":
        return (bp.target.size_out,)
    if bp.kind == "ens_decoded":
        return (bp.target.dim,)
    if bp.kind in ("activities", "voltage"):
        be = bp.target
        nl = be.n - be.n_pad
        if bp.elem_index is not None:
            return (nl,)
        return (be.k, nl) if be.batched else (nl,)
    if bp.kind == "weights":
        d = bp.target.decoders.shape[-1]
        n = bp.target.pre.n if bp.target.pre_kind.startswith("e") else None
        dec = bp.target.decoders
        return tuple(dec.shape[::-1]) if dec.ndim == 2 else tuple(dec.shape)
    if bp.kind == "scaled_encoders":
        return tuple(bp.target.post.scaled_encoders.shape)
    raise TypeError(bp.kind)


def _topo_sort(model: Model):
    """Order computable units (nodes + ensembles) respecting same-step
    (synapse=None) dependencies.  Filtered connections read carry state, so
    they impose no ordering."""
    units: List[Tuple[str, Any]] = []
    unit_ids = {}
    for info in model.node_info.values():
        u = ("node", info["node"])
        unit_ids[id(info["node"])] = len(units)
        units.append(u)
    for be in model.ensembles:
        u = ("ens", be)
        unit_ids[id(be)] = len(units)
        units.append(u)

    n_units = len(units)
    edges = [[] for _ in range(n_units)]
    indeg = [0] * n_units

    def unit_of(kind, obj):
        return unit_ids[id(obj)]

    for bc in model.connections:
        if bc.synapse is not None:
            continue
        # pre unit
        if bc.pre_kind == "node":
            src = unit_of("node", bc.pre)
        else:
            src = unit_of("ens", bc.pre)
        # post unit
        if bc.post_kind in ("node",):
            dst = unit_of("node", bc.post)
        elif bc.post_kind in ("ens", "ea_elem", "neurons", "ea_batch"):
            dst = unit_of("ens", bc.post)
        elif bc.post_kind in ("pes", "voja"):
            continue  # rule inputs are consumed in the update phase
        else:
            raise TypeError(bc.post_kind)
        edges[src].append(dst)
        indeg[dst] += 1

    from collections import deque
    q = deque(i for i in range(n_units) if indeg[i] == 0)
    order = []
    while q:
        i = q.popleft()
        order.append(units[i])
        for j in edges[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                q.append(j)
    if len(order) != n_units:
        raise RuntimeError(
            "instantaneous (synapse=None) cycle detected in the network graph; "
            "add a synapse somewhere on the loop")
    return order
