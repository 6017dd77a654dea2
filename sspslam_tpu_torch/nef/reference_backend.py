"""Pure-NumPy per-step reference interpreter.

Port of :mod:`sspslam_tpu.nef.reference_backend`: a slow, transparent
oracle that executes the same built :class:`Model` with the executor's op
schedule, one step at a time on the host in NumPy.  It cross-checks the
Simulator (the counterpart of the reference project's cpu-vs-ocl backend
check) and is ``run_slam`` / ``run_pathint``'s ``--backend numpy``.

Nothing of it touches a device.  Every table the model holds on one (a
decoder the solver left on the card, a bf16 hoisted bank) comes back to
the host as float32 once, at construction.  A node function with an
``np_function`` mirror runs the mirror; any other node or connection
function is called with CPU tensors (hoisted consts as CPU tensors) and
its result comes back as an array.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .builder import BuiltConnection, Model
from .executor import sparse_probe_value

__all__ = ["NumpyStepper"]


def _host32(x) -> np.ndarray:
    """A float32 host copy of a model table (a tensor on any device, in any
    float dtype, or an array)."""
    if torch.is_tensor(x):
        return x.detach().cpu().float().numpy()
    return np.array(x, np.float32)


def _cpu(x) -> torch.Tensor:
    """A hoisted table as a CPU tensor in its own dtype (the torch node
    functions' view)."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    return torch.as_tensor(np.asarray(x))


def _lif_step_np(nt, state, J, dt):
    voltage = state["voltage"]
    refractory = state["refractory"] - dt
    delta_t = np.clip(dt - refractory, 0.0, dt)
    voltage = voltage + (J - voltage) * -np.expm1(-delta_t / nt.tau_rc)
    spiked = voltage > 1.0
    denom = np.where(spiked, np.maximum(J - 1.0, 1e-12), 1.0)
    overshoot = np.clip((voltage - 1.0) / denom, 0.0, 1.0 - 1e-6)
    t_spike = dt + nt.tau_rc * np.log1p(-overshoot)
    out = np.where(spiked, nt.amplitude / dt, 0.0)
    voltage = np.where(spiked, 0.0, np.maximum(voltage, nt.min_voltage))
    refractory = np.where(spiked, nt.tau_ref + t_spike, refractory)
    return {"voltage": voltage, "refractory": refractory}, out


def _neuron_step_np(nt, state, J, dt):
    kind = type(nt).__name__
    if kind in ("LIF", "SurrogateLIF"):  # identical forward pass
        return _lif_step_np(nt, state, J, dt)
    if kind == "QuantizedLIF":
        st, out = _lif_step_np(nt, state, J, dt)
        q = float(nt.levels)
        st["voltage"] = np.round(st["voltage"] * q) / q
        return st, out
    if kind == "LoihiLIF":
        voltage = state["voltage"]
        refractory = state["refractory"] - dt
        delta_t = np.clip(dt - refractory, 0.0, dt)
        voltage = voltage + (J - voltage) * -np.expm1(-delta_t / nt.tau_rc)
        spiked = voltage > 1.0
        out = np.where(spiked, nt.amplitude / dt, 0.0)
        voltage = np.where(spiked, 0.0, np.maximum(voltage, nt.min_voltage))
        tau_ref_q = dt * np.round(nt.tau_ref / dt)
        refractory = np.where(spiked, tau_ref_q + dt, refractory)
        return {"voltage": voltage.astype(np.float32),
                "refractory": refractory.astype(np.float32)}, out
    if kind in ("LIFRate", "RectifiedLinear"):
        return state, nt.rates_np(J)
    if kind == "SpikingRectifiedLinear":
        v = state["voltage"] + np.maximum(J, 0.0) * dt
        n_spikes = np.floor(v)
        return {"voltage": v - n_spikes}, (nt.amplitude / dt) * n_spikes
    raise NotImplementedError(kind)


def _torch_call(f, *args, **kwargs):
    """``f`` (a torch node or connection function) on CPU tensors of
    ``args``; its result (a tensor or a tuple of them) as arrays."""
    out = f(*[torch.from_numpy(np.asarray(a, np.float32))
              if isinstance(a, np.ndarray) else a for a in args], **kwargs)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


class NumpyStepper:
    """Interpret a built Model one dt at a time on the host."""

    def __init__(self, model: Model, hoisted: Optional[dict] = None):
        self.model = model
        self.dt = model.dt
        # hoisted node tables: the build's by default; pass
        # sim.params["hoisted"] to follow tables rewritten in place (a
        # swept gate).  Mirrors read float32 arrays, torch functions CPU
        # tensors in the table's own dtype
        src = model.hoisted if hoisted is None else hoisted
        self.hoisted = {k: {n: _host32(v) for n, v in t.items()}
                        for k, t in src.items()}
        self._hoisted_cpu = {k: {n: _cpu(v) for n, v in t.items()}
                             for k, t in src.items()}
        self.state = self._initial_state()
        self._filt_coeffs = [(a, b) for (_s, a, b) in model.filter_specs]
        # incoming connection tables (same grouping as the executor)
        self.node_in: Dict[int, list] = {}
        self.ens_in: Dict[int, list] = {}
        self.ens_cur: Dict[int, list] = {}
        for bc in model.connections:
            if bc.post_kind == "node":
                self.node_in.setdefault(id(bc.post), []).append(bc)
            elif bc.post_kind in ("ens", "ea_elem", "ea_batch"):
                self.ens_in.setdefault(bc.post.index, []).append(bc)
            elif bc.post_kind == "neurons":
                self.ens_cur.setdefault(bc.post.index, []).append(bc)
        # host float32 copies of every table the step reads, made once
        self._np_dec: Dict[int, np.ndarray] = {
            bc.index: _host32(bc.decoders)
            for bc in model.connections if bc.decoders is not None}
        self._np_w: Dict[int, np.ndarray] = {
            bc.index: _host32(bc.weights)
            for bc in model.connections if bc.weights is not None}
        self._np_probe_dec: Dict[int, np.ndarray] = {
            bp.index: _host32(bp.decoders)
            for bp in model.probes if bp.decoders is not None}
        self._np_enc = [_host32(be.scaled_encoders) for be in model.ensembles]
        self._np_bias = [_host32(be.bias) for be in model.ensembles]
        self._np_scale = [(_host32(be.gain) / be.radius).astype(np.float32)
                          for be in model.ensembles]
        self._np_const = {k: _host32(info["const"])
                          for k, info in model.node_info.items()
                          if info["kind"] == "const"}

    def _initial_state(self):
        m = self.model
        neurons = []
        for be in m.ensembles:
            shape = (be.k, be.n) if be.batched else (be.n,)
            nt = be.neuron_type
            if nt.spiking:
                st = {"voltage": np.zeros(shape, np.float32)}
                if type(nt).__name__ in ("LIF", "QuantizedLIF", "LoihiLIF",
                                         "SurrogateLIF"):
                    st["refractory"] = np.zeros(shape, np.float32)
                neurons.append(st)
            else:
                neurons.append({})
        return {
            "step": 0,
            "neurons": neurons,
            "filters": [np.zeros(s, np.float32) for s, _a, _b in m.filter_specs],
            "learned": {k: _host32(v) for k, v in m.learned_init.items()},
            "nodes": {k: _host32(v) for k, v in m.node_state_init.items()},
        }

    def sparse_probe(self, bp):
        """Read a sparse (weights / scaled_encoders) probe from the current
        interpreter state, as the Simulator reads it at a segment
        boundary."""
        return sparse_probe_value(self.model, self.state, bp)

    # ------------------------------------------------------------------
    def run_steps(self, n_steps: int, input_tables):
        """input_tables: list of (n_steps, size) arrays in model.input_nodes
        order.  Returns probe emissions {probe_index: (n_steps, ...)} for
        dense probes."""
        m = self.model
        emits = {bp.index: [] for bp in m.probes if not bp.sparse}
        for i in range(n_steps):
            out = self._step([tab[i] for tab in input_tables])
            for k, v in out.items():
                emits[k].append(v)
        return {k: np.stack(v) for k, v in emits.items()}

    def _node_output(self, obj, info, t, x):
        """The output of jnp-function node ``obj`` on input ``x``: its
        NumPy mirror where it has one, else its torch function on CPU
        tensors; a stateful node's state is advanced in place."""
        st = self.state
        np_f = info.get("np_func")
        hk = info.get("hoisted_key")
        slot = info.get("state_slot")
        if np_f is not None:
            kw = {"consts": self.hoisted[hk]} if hk is not None else {}
            if slot is None:
                return np_f(t, x, **kw)
            out, ns = np_f(t, x, st["nodes"][slot], **kw)
        else:
            kw = {"consts": self._hoisted_cpu[hk]} if hk is not None else {}
            # the executor's time: a float32 tensor
            t32 = torch.tensor(st["step"] + 1, dtype=torch.float32) * self.dt
            if slot is None:
                return _torch_call(obj.output, t32, x, **kw) \
                    if obj.size_in > 0 else _torch_call(obj.output, t32)
            out, ns = _torch_call(obj.output, t32, x, st["nodes"][slot], **kw)
        st["nodes"][slot] = np.asarray(ns, np.float32)
        return out

    def _step(self, xs):
        m = self.model
        dt = self.dt
        st = self.state
        t = (st["step"] + 1) * dt
        filters = st["filters"]
        learned = st["learned"]
        sig_node: Dict[int, np.ndarray] = {}
        sig_act: Dict[int, np.ndarray] = {}
        input_index = {id(n): i for i, n in enumerate(m.input_nodes)}

        def decoders_of(bc):
            if bc.learned_slot is not None:
                return learned[bc.learned_slot]
            return self._np_dec[bc.index]

        def pre_value(bc: BuiltConnection):
            if bc.pre_kind == "node":
                v = sig_node[id(bc.pre)]
                if bc.pre_indices is not None:
                    v = v[bc.pre_indices]
                return v
            act = sig_act[bc.pre.index]
            if bc.pre_kind in ("ens", "ens_view"):
                return act @ decoders_of(bc)
            if bc.pre_kind == "ea_elem":
                return act[bc.ea_elem_index] @ decoders_of(bc)
            if bc.pre_kind == "ea_batch":
                if bc.ea_rows is not None:   # fused-EA member rows
                    off, kk = bc.ea_rows
                    act = act[off:off + kk]
                return np.einsum("kn,knd->kd", act, decoders_of(bc))
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

        def current_value(bc):
            v = pre_value(bc)
            if bc.jnp_function is not None:
                np_f = getattr(bc.jnp_function, "np_function", None)
                v = (np.asarray(np_f(v)) if np_f is not None
                     else _torch_call(bc.jnp_function, v)).reshape(-1)
            if bc.pre_kind == "ea_batch" and bc.post_kind == "node":
                v = v.reshape(-1)
            if bc.weights is not None:
                W = self._np_w[bc.index]
                if bc.full_weights:  # neuron->neuron currents (solver_weights)
                    v = (np.einsum("knm,km->kn", W, v) if W.ndim == 3
                         else W @ v)
                elif W.ndim == 3:
                    v = np.einsum("kds,s->kd", W, v)
                else:
                    v = W @ v
            elif bc.scalar_weight != 1.0:
                v = bc.scalar_weight * v
            return np.asarray(v, np.float32)

        def conn_output(bc):
            if bc.synapse is not None:
                return filters[bc.filt_index]
            return current_value(bc)

        for kind, obj in m.topo_units:
            if kind == "node":
                info = m.node_info[id(obj)]
                nk = info["kind"]
                if nk == "tabulated":
                    sig_node[id(obj)] = np.asarray(xs[input_index[id(obj)]],
                                                   np.float32)
                elif nk == "const":
                    sig_node[id(obj)] = self._np_const[id(obj)]
                else:
                    x = np.zeros(obj.size_in, np.float32)
                    for bc in self.node_in.get(id(obj), []):
                        v = conn_output(bc)
                        if bc.post_indices is not None:
                            x[bc.post_indices] += v
                        else:
                            x += v
                    if nk == "jnp_func":
                        out = self._node_output(obj, info, t, x)
                        sig_node[id(obj)] = np.asarray(
                            out, np.float32).reshape(-1)
                    else:
                        sig_node[id(obj)] = x
            else:
                be = obj
                shape = (be.k, be.dim) if be.batched else (be.dim,)
                x = np.zeros(shape, np.float32)
                for bc in self.ens_in.get(be.index, []):
                    v = conn_output(bc)
                    if bc.post_kind == "ea_batch":
                        if bc.ea_rows is not None:
                            off, kk = bc.ea_rows
                            x[off:off + kk] += v.reshape(
                                (kk,) + shape[1:])
                        else:
                            x += v.reshape(shape)
                    elif bc.post_kind == "ea_elem":
                        if bc.post_indices is not None:
                            x[bc.post_elem_index, bc.post_indices] += v
                        else:
                            x[bc.post_elem_index] += v
                    else:
                        if bc.post_indices is not None:
                            x[bc.post_indices] += v
                        else:
                            x += v
                E = (learned[f"voja_{be.voja_conn_index}"]
                     if be.voja_conn_index is not None
                     else self._np_enc[be.index])
                if be.batched:
                    J = np.einsum("knd,kd->kn", E, x) + self._np_bias[be.index]
                else:
                    J = E @ x + self._np_bias[be.index]
                for bc in self.ens_cur.get(be.index, []):
                    v = conn_output(bc)
                    nl = be.n - be.n_pad
                    if bc.full_weights or be.n_pad == 0:
                        if bc.post_elem_index is not None:  # fused element
                            J = J.copy()
                            J[bc.post_elem_index] += v
                        else:
                            J = J + (v.reshape(J.shape)
                                     if v.size == J.size else v)
                    elif bc.post_elem_index is not None:
                        J = J.copy()
                        J[bc.post_elem_index, :nl] += v
                    else:
                        J = J.copy()
                        J[..., :nl] += v.reshape(J.shape[:-1] + (nl,))
                ns, out = _neuron_step_np(be.neuron_type,
                                          st["neurons"][be.index], J, dt)
                st["neurons"][be.index] = ns
                sig_act[be.index] = out

        new_filters = list(filters)
        cascade = m.filter_cascade

        def update_filter(fi, u):
            a, b = self._filt_coeffs[fi]
            if fi in cascade:  # Alpha: first stage feeds the output stage
                h = cascade[fi]
                ah, bh = self._filt_coeffs[h]
                u = ah * filters[h] + bh * u
                new_filters[h] = u
            new_filters[fi] = a * filters[fi] + b * u

        for bc in m.connections:
            if bc.filt_index is not None:
                update_filter(bc.filt_index, current_value(bc))
            if bc.pes_act_filt_index is not None:
                src = (sig_act[bc.post.index] if bc.voja_rule is not None
                       else sig_act[bc.pre.index])
                update_filter(bc.pes_act_filt_index, src)

        for bc in m.connections:
            if bc.pes_rule is not None:
                err = np.zeros(learned[bc.learned_slot].shape[-1],
                               np.float32)
                for rci in bc.rule_target_conns:
                    err = err + conn_output(m.connections[rci])
                acts = (new_filters[bc.pes_act_filt_index]
                        if bc.pes_act_filt_index is not None
                        else sig_act[bc.pre.index])
                alpha = (bc.pes_rule.learning_rate * dt
                         / (bc.pre.n - bc.pre.n_pad))
                learned[bc.learned_slot] = (
                    learned[bc.learned_slot] - alpha * np.outer(acts, err))
            elif bc.voja_rule is not None:
                gate = 0.0
                for rci in bc.rule_target_conns:
                    gate = gate + conn_output(m.connections[rci])
                ls = 1.0 + np.asarray(gate).reshape(-1)[0]
                be = bc.post
                acts = (new_filters[bc.pes_act_filt_index]
                        if bc.pes_act_filt_index is not None
                        else sig_act[be.index])
                pre_v = current_value(bc)
                scale = self._np_scale[be.index]
                alpha = bc.voja_rule.learning_rate * dt * ls
                E = learned[bc.learned_slot]
                learned[bc.learned_slot] = E + alpha * (
                    scale[:, None] * np.outer(acts, pre_v)
                    - acts[:, None] * E)

        out = {}
        for bp in m.probes:
            if bp.kind == "node":
                v = sig_node[id(bp.target)]
            elif bp.kind == "ens_decoded":
                act = sig_act[bp.target.index]
                if bp.elem_index is not None:
                    act = act[bp.elem_index]
                v = act @ self._np_probe_dec[bp.index]
            elif bp.kind == "activities":
                v = sig_act[bp.target.index]
                if bp.elem_index is not None:
                    v = v[bp.elem_index]
                if bp.target.n_pad:
                    v = v[..., :bp.target.n - bp.target.n_pad]
            elif bp.kind == "voltage":
                v = st["neurons"][bp.target.index]["voltage"]
                if bp.elem_index is not None:
                    v = v[bp.elem_index]
                if bp.target.n_pad:
                    v = v[..., :bp.target.n - bp.target.n_pad]
            elif bp.kind == "weights":
                D = (learned[bp.target.learned_slot]
                     if bp.target.learned_slot
                     else self._np_dec[bp.target.index])
                v = D.T if D.ndim == 2 else D
            elif bp.kind == "scaled_encoders":
                v = learned[bp.target.learned_slot]
            else:
                raise TypeError(bp.kind)
            if bp.filt_index is not None:
                a, b = self._filt_coeffs[bp.filt_index]
                if bp.filt_index in cascade:
                    h = cascade[bp.filt_index]
                    ah, bh = self._filt_coeffs[h]
                    v = ah * new_filters[h] + bh * v
                    new_filters[h] = v
                v = a * new_filters[bp.filt_index] + b * v
                new_filters[bp.filt_index] = v
            if not bp.sparse:
                out[bp.index] = np.array(v)

        st["filters"] = new_filters
        st["step"] += 1
        return out
