"""The SLAM cells' check: the program's run held to the reference
(:mod:`.slam`), and the control in the program's place.

Five numbers decide ``correct``:

- ``table_gap``: the worst fixed table, ||p - r|| / ||r||: every
  ensemble's scaled encoders, gains and biases (the OVCs' encoders among
  them, the key population's as Voja starts from them), the fixed
  transforms (the DFT maps, the velocity map, both convolutions' and
  their squaring populations'), the clean-up's float32 grid and its
  scoring bank in its stated dtype, the gate's threshold and rate;
- ``decode_gap``: every solved decoder by what it decodes, ||A (D_p -
  D_r)|| / ||A D_r|| with A the reference's rates at its evaluation
  points (the decoders themselves are ill-conditioned);
- ``start_gap``: the run's first K PI output rows against the reference's
  K steps from rest, oscillator by oscillator (:func:`.check.
  oscillator_gap`);
- ``chunk_gap``: from the state the program held at the judged unit's
  start, its K replayed steps against the reference's K steps from the
  same state: the PI output rows (as ``start_gap``), and the recall and
  the position estimate the state holds after them (||p - r||: SSP-scale
  vectors, near zero while the map is empty); infinite when the replay
  did not give the window's rows bitwise;
- ``learn_gap``: the PES decoders' and the Voja encoders' change over
  those K steps against the reference's, ||dL_p - dL_r|| / ||dL_r||, the
  worse of the two;

A sixth, ``track_err``, is read and logged but decides nothing: the median
distance between the program's self-position, its PI output rows decoded
by the reference's grid, and the path over the window's simulated time.
At the configuration's published gate (update threshold 0.2, shift rate
0.2) the correction holds the error near the view radius, while the path
integrator alone has mostly not drifted yet within a window's first 120 s
of the world: a shut gate tracks better there, so no limit on it sits
between the sound runs and the faults it should catch.

A spiking run parts from any other computation of itself within a few
hundred steps, so the reference follows the program's state at the judged
unit rather than the whole run.  What the program made is read only to be
judged.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import core
from benchmark.harness import slam_world as SW
from benchmark.harness import world as W

from . import check, slam, ssp

NAMES = ("table_gap", "decode_gap", "start_gap", "chunk_gap", "learn_gap")


# ---------------------------------------------------------------------------
# the program's side: where its tables and state leaves are
# ---------------------------------------------------------------------------

def layout(model, net, bp) -> dict:
    """Where the program keeps what the reference names: each population's
    (group index, element or row range), each synapse's filter slot, each
    decoder's and transform's connection, the learned slots, the hoisted
    tables."""
    conns = model.connections

    def one(pred, what):
        found = [bc for bc in conns if pred(bc)]
        if len(found) != 1:
            raise RuntimeError(f"{what}: {len(found)} connections")
        return found[0]

    def objs(be):
        return be.obj if isinstance(be.obj, tuple) else (be.obj,)

    am, pi = net.assomemory, net.pathintegrator
    cc = {"cc1": net.landmark_ssp_ens, "cc2": net.position_estimate}
    pops = {}
    for be in model.ensembles:
        for j, o in enumerate(objs(be)):
            for name, target in (("ovc", net.ovc_ens), ("recall", am.recall),
                                 ("memory", am.memory), ("error", am.error),
                                 ("vco", pi.oscillators),
                                 ("cc1", cc["cc1"].product.sq),
                                 ("cc2", cc["cc2"].product.sq)):
                if o is target:
                    if be.batched and len(objs(be)) > 1 and \
                            name in ("cc1", "cc2"):
                        row0 = sum(x.n_ensembles for x in objs(be)[:j])
                        pops[name] = (be.index, ("rows", row0,
                                                 o.n_ensembles))
                    elif be.batched and len(objs(be)) > 1:
                        pops[name] = (be.index, ("elem", j))
                    else:
                        pops[name] = (be.index, None)
    g = {k: v for k, v in pops.items()}
    vco_i = g["vco"][0]

    def is_elem(bc, name, side):
        idx = bc.ea_elem_index if side == "pre" else bc.post_elem_index
        end = bc.pre if side == "pre" else bc.post
        return getattr(end, "index", None) == g[name][0] and \
            g[name][1] is not None and idx == g[name][1][1]

    pes = one(lambda bc: bc.pes_rule is not None, "PES")
    voja = one(lambda bc: bc.voja_rule is not None, "Voja")
    c = {
        "clean": one(lambda bc: bc.pre is pi.output
                     and bc.post is net.gridcells, "clean-up"),
        "value": one(lambda bc: bc.pre is cc["cc1"].output
                     and bc.post is am.value_input, "value"),
        "ovc_unit": one(lambda bc: bc.post is cc["cc2"].input_a, "ovc unit"),
        "recall_unit": one(lambda bc: bc.post is cc["cc2"].input_b,
                           "recall unit"),
        "estimate": one(lambda bc: bc.pre is cc["cc2"].output
                        and bc.post is net.update_state, "estimate"),
        "pi": one(lambda bc: bc.pre is pi.output
                  and bc.post is net.update_state, "pi"),
        "vco_rec": one(lambda bc: getattr(bc.pre, "index", None) == vco_i
                       and getattr(bc.post, "index", None) == vco_i
                       and bc.pre_kind == "ea_batch", "recurrence"),
        "error_value": one(lambda bc: bc.pre is am.value_input
                           and is_elem(bc, "error", "post"), "-value"),
        "error_recall": one(lambda bc: is_elem(bc, "recall", "pre")
                            and is_elem(bc, "error", "post"), "recall"),
        "pes_error": one(lambda bc: bc.post_kind == "pes", "error"),
        "vco.out": one(lambda bc: getattr(bc.pre, "index", None) == vco_i
                       and bc.post is pi.oscillators.output, "vco out"),
        "ovc.id": one(lambda bc: bc.post is cc["cc1"].input_b, "ovc id"),
        "to_fourier": one(lambda bc: bc.pre is pi.input
                          and bc.post is pi.oscillators.input, "to F"),
        "from_fourier": one(lambda bc: bc.pre is pi.oscillators.output
                            and bc.post is pi.output, "from F"),
        "vel": one(lambda bc: bc.pre is pi.velocity_input
                   and getattr(bc.post, "index", None) == vco_i, "vel"),
    }
    for name, net_cc in cc.items():
        p, sq = net_cc.product, net_cc.product.sq
        c[name + ".id"] = one(lambda bc: bc.post is sq.output, name + " id")
        c[name + ".sq"] = one(lambda bc: bc.post is sq.square, name + " sq")
        c[name + ".a"] = one(lambda bc: bc.pre is net_cc.input_a
                             and bc.post is p.input_a, name + " a")
        c[name + ".b"] = one(lambda bc: bc.pre is net_cc.input_b
                             and bc.post is p.input_b, name + " b")
        c[name + ".out"] = one(lambda bc: bc.pre is p.output
                               and bc.post is net_cc.output, name + " out")
        c[name + ".sq.a"] = one(lambda bc: bc.pre is p.input_a
                                and bc.post is sq.input, name + " sq a")
        c[name + ".sq.b"] = one(lambda bc: bc.pre is p.input_b
                                and bc.post is sq.input, name + " sq b")
        c[name + ".sq.out"] = one(lambda bc: bc.pre is sq.square
                                  and bc.post is p.output, name + " sq out")
    filters = {f: c[f].filt_index for f in
               ("clean", "value", "ovc_unit", "recall_unit", "estimate",
                "pi", "vco_rec", "error_value", "error_recall",
                "pes_error")}
    filters["pes_act"] = pes.pes_act_filt_index
    filters["recall_in"] = pes.filt_index
    filters["probe"] = bp.filt_index
    hoisted = {}
    for info in model.node_info.values():
        if info["node"] is net.gridcells:
            hoisted["cleanup"] = info["hoisted_key"]
        if info["node"] is net.update_state:
            hoisted["gate"] = info["hoisted_key"]
    return {"pops": pops, "conns": {k: v.index for k, v in c.items()},
            "filters": filters, "pes": pes.learned_slot,
            "voja": voja.learned_slot, "hoisted": hoisted,
            "pes_index": pes.index}


def _pick(x, where):
    """A population's part of a group's (k, n)- or (n,)-shaped leaf."""
    if where is None:
        return x
    if where[0] == "elem":
        return x[where[1]]
    return x[where[1]:where[1] + where[2]]


def program_state(state, lay) -> dict:
    """The program's state tree (host arrays) under the reference's
    names."""
    out = {}
    for name in slam.NEURONS:
        i, where = lay["pops"][name]
        out[name] = {k: _pick(v, where) for k, v in
                     state["neurons"][i].items()}
    for name in slam.FILTERS:
        out[name] = state["filters"][lay["filters"][name]]
    out["pes"] = state["learned"][lay["pes"]]
    out["voja"] = state["learned"][lay["voja"]]
    return out


def program_tables(sim, lay) -> dict:
    """The program's fixed tables under the reference's names, host
    float64 (the clean-up's scoring bank: its values, and its dtype)."""
    model, params = sim.model, sim.params
    out = {}
    for name in ("ovc", "recall", "memory", "error", "vco", "cc1", "cc2"):
        i, where = lay["pops"][name]
        be = model.ensembles[i]
        for key, attr in (("scaled", "scaled_encoders"), ("bias", "bias"),
                          ("gain", "gain")):
            out[f"{name}.{key}"] = check.host(_pick(getattr(be, attr),
                                                    where))
    out["ovc.encoders"] = check.host(_pick(
        model.ensembles[lay["pops"]["ovc"][0]].encoders,
        lay["pops"]["ovc"][1]))
    out["memory.voja0"] = check.host(model.learned_init[lay["voja"]])
    for key in ("to_fourier", "from_fourier", "vel", "cc1.a", "cc1.b",
                "cc2.a", "cc2.b", "cc1.out", "cc2.out", "cc1.sq.a",
                "cc1.sq.b", "cc2.sq.a", "cc2.sq.b", "cc1.sq.out",
                "cc2.sq.out"):
        bc = model.connections[lay["conns"][key]]
        out[key] = check.host(bc.weights if bc.weights is not None
                              else bc.scalar_weight)
    h = params["hoisted"]
    cl = h[lay["hoisted"]["cleanup"]]
    out["bank"] = check.host(cl["bank"])
    out["bank_sim"] = check.host(cl["bank_sim"].float())
    out["bank_sim.dtype"] = str(cl["bank_sim"].dtype)
    gate = h[lay["hoisted"]["gate"]]
    out["gate"] = np.array([float(gate["update_thres"]),
                            float(gate["shift_rate"])])
    return out


def program_decoders(sim, lay) -> dict:
    """The program's solved decoders under :data:`slam.DECODERS`' names,
    host float64: (n, c), or (k, n, c) for an array."""
    model = sim.model
    out = {}
    for key in slam.DECODERS:
        if key == "memory.pes":
            out[key] = check.host(model.learned_init[lay["pes"]])
            continue
        conn = {"vco.rec": "vco_rec", "ovc.unit": "ovc_unit",
                "recall.unit": "recall_unit", "recall.id": "error_recall",
                "error.id": "pes_error"}.get(key, key)
        out[key] = check.host(model.connections[lay["conns"][conn]]
                              .decoders)
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def world(cfg, mix, seed) -> dict:
    """The run's world as the reference reads it: the path, velocities at
    the reference's own scale, landmarks, SPs and the initial clamp."""
    ms = W.model_seed(seed)
    path, vels = SW.path(mix, seed)
    phase = ssp.phase_matrix(cfg["domain_dim"], cfg["ssp_dim"])
    m = np.max(np.abs(phase @ vels.T))
    scale = float(1.0 / m) if np.isfinite(m) and m > 0 else 1.0
    return {"path": path, "vels": vels, "scale": scale, "phase": phase,
            "obj": SW.landmarks(cfg, ms), "ms": ms,
            "sps": slam.sp_vectors(cfg["n_landmarks"], cfg["ssp_dim"], ms)}


def input_rows(cfg, wd, start: int, K: int, device) -> dict:
    """The input rows of world steps ``start`` .. ``start + K - 1``: the
    scaled velocity, the initial clamp (``run_slam.py``'s row index
    ``int((t - dt) / dt)`` while t < ``clamp_s``), the sum of the in-view
    landmarks' vector SSPs and SPs, and the not-in-view signal (0 seen,
    10 not)."""
    dt, d = cfg["dt"], cfg["ssp_dim"]
    T = wd["path"].shape[0]
    idx = np.minimum(np.arange(start, start + K), T - 1)
    p = wd["path"][idx]
    seen = SW.in_view(cfg, p, wd["obj"])
    vec = wd["obj"][None, :, :] - p[:, None, :]
    enc = ssp.encode(wd["phase"], cfg["length_scale"],
                     vec.reshape(-1, 2)).reshape(K, -1, d)
    init = np.zeros((K, d))
    head = ssp.encode(wd["phase"], cfg["length_scale"], wd["path"][:60])
    for i, step_no in enumerate(idx):
        t = (step_no + 1) * dt
        if t < cfg["clamp_s"]:
            init[i] = head[min(int((t - dt) / dt), 59)]
    rows = {"vel": wd["vels"][idx] * wd["scale"], "init": init,
            "vecssp": np.einsum("tl,tld->td", seen, enc),
            "sp": seen.astype(np.float64) @ wd["sps"],
            "no_view": np.where(seen.any(axis=1), 0.0, 10.0)[:, None]}
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in rows.items()}


def to_device(state: dict, device) -> dict:
    return {k: ({kk: torch.as_tensor(vv, dtype=torch.float32,
                                     device=device) for kk, vv in v.items()}
                if isinstance(v, dict) else
                torch.as_tensor(v, dtype=torch.float32, device=device))
            for k, v in state.items()}


def ref_tables(net) -> dict:
    """The reference's fixed tables under the names of
    :func:`program_tables` (float64 host; the control's as rounded)."""
    tf = net["tf32"]
    dr = net["draws"]
    out = {}
    for name in ("ovc", "recall", "memory", "error", "vco", "cc1", "cc2"):
        e = dr[name]
        out[f"{name}.scaled"] = (check.host(net[name]["E"]) if tf
                                 else e["scaled"])
        out[f"{name}.bias"] = e["bias"]
        out[f"{name}.gain"] = e["gain"]
    out["ovc.encoders"] = dr["ovc"]["encoders"]
    out["memory.voja0"] = out["memory.scaled"]
    T = {k: check.host(v) for k, v in net["T"].items()}
    k = (net["d"] + 1) // 2
    vel = np.zeros((k, 3, 2))
    vel[:, 2, :] = T["vel"]
    out.update({"to_fourier": T["to_fourier"],
                "from_fourier": T["from_fourier"], "vel": vel,
                "cc1.a": T["cc1.a"], "cc1.b": T["cc1.b"],
                "cc2.a": T["cc2.a"], "cc2.b": T["cc2.b"],
                "cc1.out": T["cc.out"], "cc2.out": T["cc.out"]})
    for name in ("cc1", "cc2"):
        out[name + ".sq.a"] = T["sq.a"]
        out[name + ".sq.b"] = T["sq.b"]
        out[name + ".sq.out"] = T["sq.out"]
    out["bank"] = check.host(net["bank"])
    out["bank_sim"] = check.host(net["bank_sim"].float())
    out["bank_sim.dtype"] = str(net["bank_sim"].dtype)
    out["gate"] = np.array(net["gate"])
    return out


def table_gap(prog: dict, ref: dict):
    gaps = {}
    for name, r in ref.items():
        if name.endswith(".dtype"):
            gaps[name] = 0.0 if prog[name] == r else float("inf")
        else:
            gaps[name] = check.rel_gap(prog[name], r)
    return check.worst(gaps)


def decode_gap(prog: dict, net) -> tuple:
    gaps = {}
    for key in slam.DECODERS:
        A = net["rates"][key]                            # (k, P, n)

        def batch(D):
            D = torch.as_tensor(check.host(D), device=A.device)
            return D if D.ndim == 3 else D[None]
        gaps[key] = check.rel_gap(A @ batch(prog[key]),
                                  A @ batch(net["dec"][key]))
    return check.worst(gaps)


def dist(p, r) -> float:
    """||p - r|| of two SSP-scale vectors (norm 1 or less): unlike a
    relative gap it does not blow up while both are near zero, as the
    recall and the estimate are while the map is still empty."""
    return float(np.linalg.norm(check.host(p) - check.host(r)))


def delta_gap(p1, p0, r1, r0) -> float:
    """||(p1 - p0) - (r1 - r0)|| / ||r1 - r0||."""
    return check.rel_gap(check.host(p1) - check.host(p0),
                         check.host(r1) - check.host(r0))


def decode_points(net, rows: np.ndarray, device) -> np.ndarray:
    """SSP rows decoded by the reference's grid: the grid point of the
    most similar grid SSP (float32)."""
    bank = net["bank"]
    out = []
    for a in range(0, rows.shape[0], 4096):
        r = torch.as_tensor(np.asarray(rows[a:a + 4096], np.float32),
                            device=bank.device)
        out.append(torch.argmax(r @ bank.T, dim=1).cpu().numpy())
    return net["points"][np.concatenate(out)] if out else \
        np.zeros((0, 2))


def track_err(net, out, wd, device) -> float:
    """Median distance of the program's decoded self-position from the
    path over the window's rows (world steps wrap at the world's end)."""
    if not out["track"]:
        return float("inf")
    steps = np.concatenate([s for s, _ in out["track"]])
    rows = np.concatenate([r for _, r in out["track"]])
    pts = decode_points(net, rows, device)
    p = wd["path"][steps % out["world_steps"]]
    return float(np.median(np.linalg.norm(pts - p, axis=1)))


def gaps(cfg, mix, out, net, wd, device, y_start, ref_after, ref_rows):
    """The five judged numbers of ``out`` (the program's, or the
    control's in its place) against the reference and ``track_err``, and
    where each is worst."""
    table = table_gap(out["tables"], ref_tables(net))
    decode = decode_gap(out["decoders"], net)
    start = check.oscillator_gap(out["first"], y_start)
    where = {"table_gap": table[1], "decode_gap": decode[1]}
    if "snap" in out:
        chunk = {"pi": check.oscillator_gap(out["chunk_rows"], ref_rows),
                 "recall": dist(out["after"]["error_recall"],
                                ref_after["error_recall"]),
                 "estimate": dist(out["after"]["estimate"],
                                  ref_after["estimate"])}
        if not out.get("replay_equal", True):
            chunk["replay"] = float("inf")
        learn = {name: delta_gap(out["after"][name], out["snap"][name],
                                 ref_after[name], out["snap"][name])
                 for name in slam.LEARNED}
        chunk_v, where["chunk_gap"] = check.worst(chunk)
        learn_v, where["learn_gap"] = check.worst(learn)
    else:
        chunk_v = learn_v = float("inf")
        where["chunk_gap"] = where["learn_gap"] = "no unit judged"
    track = out.get("track_err")
    if track is None:
        track = track_err(net, out, wd, device)
    return ({"table_gap": table[0], "decode_gap": decode[0],
             "start_gap": start, "chunk_gap": chunk_v,
             "learn_gap": learn_v, "track_err": track}, where)


def reference_runs(cfg, mix, out, net, wd, device):
    """The reference's K steps from rest and from the program's state at
    the judged unit: (rows from rest, state after the unit's K steps,
    its rows)."""
    K = mix["check_rows"]
    _, y_start = slam.run(net, slam.at_rest(net),
                          input_rows(cfg, wd, 0, K, device))
    if "snap" not in out:
        return y_start.cpu().double().numpy(), None, None
    s0 = to_device(out["snap"], device)
    after, rows = slam.run(net, s0, input_rows(cfg, wd, out["snap_step"],
                                               K, device))
    host = {k: ({kk: check.host(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else check.host(v))
            for k, v in after.items()}
    return y_start.cpu().double().numpy(), host, \
        rows.cpu().double().numpy()


def control_outputs(cfg, mix, seed, out, wd, device) -> dict:
    """The control in the program's place: the reference with every
    contraction's operands rounded to TF32, its tables and decoders, its
    K steps from rest and from the program's state at the judged unit.
    It runs no window of its own, so it reads no ``track_err`` (NaN)."""
    net = slam.build(cfg, wd["ms"], wd["scale"], device, tf32=True)
    K = mix["check_rows"]
    tables = ref_tables(net)
    ctl = {"tables": tables,
           "decoders": {k: net["dec"][k] for k in slam.DECODERS},
           "track_err": float("nan")}
    _, rows = slam.run(net, slam.at_rest(net),
                       input_rows(cfg, wd, 0, K, device))
    ctl["first"] = rows.cpu().double().numpy()
    if "snap" in out:
        after, rows = slam.run(net, to_device(out["snap"], device),
                               input_rows(cfg, wd, out["snap_step"], K,
                                          device))
        ctl.update(snap=out["snap"], snap_step=out["snap_step"],
                   chunk_rows=rows.cpu().double().numpy(),
                   after={k: ({kk: check.host(vv) for kk, vv in v.items()}
                              if isinstance(v, dict) else check.host(v))
                          for k, v in after.items()})
    return ctl


def readings(cfg, mix, seed, device, out) -> dict:
    """The compared numbers of the program's run and of the control's (for
    setting the limits)."""
    wd = world(cfg, mix, seed)
    net = slam.build(cfg, wd["ms"], wd["scale"], device)
    y_start, after, rows = reference_runs(cfg, mix, out, net, wd, device)
    ctl = control_outputs(cfg, mix, seed, out, wd, device)
    return {"program": gaps(cfg, mix, out, net, wd, device, y_start, after,
                            rows),
            "control": gaps(cfg, mix, ctl, net, wd, device, y_start, after,
                            rows)}


def judge(ctx, out) -> None:
    cfg, mix = ctx.cfg, ctx.mix
    t0 = time.perf_counter()
    wd = world(cfg, mix, ctx.seed)
    net = slam.build(cfg, wd["ms"], wd["scale"], ctx.device)
    t1 = time.perf_counter()
    y_start, after, rows = reference_runs(cfg, mix, out, net, wd,
                                          ctx.device)
    g, where = gaps(cfg, mix, out, net, wd, ctx.device, y_start, after,
                    rows)
    core.log(f"reference: build {t1 - t0:.1f} s, unit {out['unit']} "
             f"(step {out.get('snap_step')}), replay equal "
             f"{out.get('replay_equal')}, {time.perf_counter() - t1:.1f} s; "
             f"worst: {where}")
    core.log(f"track_err (read, not judged): {g['track_err']!r}")
    for name in NAMES:
        ctx.checks.append((name, float(g[name]),
                           float(mix["limits"][name])))
