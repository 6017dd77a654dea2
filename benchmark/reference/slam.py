"""SSP-SLAM's reference: the flagship network of ``run_slam.py`` (Dumont,
Furlong, Orchard, Eliasmith 2023, Frontiers in Neuroscience 17), drawn,
solved and stepped in plain PyTorch and float32.

The network, as the paper and ``run_slam.py`` give it:

- a path integrator: ``k = (d + 1) // 2`` velocity-controlled oscillators
  of ``pi_n_neurons`` LIF each (:mod:`.vco`'s bank: the SSP's spectral rows
  as (Re, Im, omega), the limit-cycle recurrence through a 50 ms synapse,
  oscillator 0 held at [1, 0, 0]), read out as an SSP through the inverse
  DFT;
- object-vector cells: ``mem_n_neurons`` LIF whose encoders are the SSPs
  of displacements scattered over the unit disc (an R_d sequence, its
  radius from a magnitude of 1e-3 up, turned by a random rotation), fed
  the egocentric landmark SSP;
- a grid clean-up of the filtered self-position: the most similar of the
  SSPs of a ``cleanup_samples_per_dim``² grid over the domain;
- two circular convolutions (Gosmann's alignment: four product channels
  per retained frequency, each product a pair of squaring populations of
  ``circonv_n_neurons // 2`` LIF): the cleaned self-position bound with
  the OVC vector (the landmark's allocentric SSP), and the OVC vector,
  inverted, bound with the memory's recall (the position estimate), both
  operands of the second made unitary by their decoders;
- an associative memory: a ``mem_n_neurons`` key population with fixed
  intercepts whose encoders Voja pulls toward the landmark's SP, a recall
  population decoded through PES-learned decoders (starting at zero), and
  an error population (recall - value) that the not-in-view signal
  silences;
- the reference gate: ``shift_rate (estimate - PI)`` into the path
  integrator while a landmark is in view and the two agree above
  ``update_thres``.

Every ensemble is drawn as the program's builder draws it: one stream per
ensemble, seeded by the next draw of ``default_rng(seed)``, the single
ensembles first (the OVCs, recall, the key population, error) and then the
arrays (the oscillators, then each convolution's squaring populations):
max rates uniform on [200, 400) Hz, intercepts uniform on [-1, 0.9) (the
key population's fixed), encoders uniform on the sphere (the OVCs' given),
then evaluation points uniform in the ball, scaled by the radius.  LIF
gains and biases (tau_rc 20 ms, tau_ref 2 ms); decoders are L2-regularised
least squares (sigma = 0.1 of the ensemble's largest rate) solved by
Cholesky in float32, per ensemble.

The step follows the engine's order: the same-step (unfiltered) paths in
dependency order, every synapse reading its state from the step before,
then the synapses updated from this step's values, then PES (the filtered
error of the step before against this step's filtered key activities) and
Voja (learning signal 1 + the not-in-view input), then the probe.

Departures from the published description, each the configuration's
statement:

- the clean-up scores the bank in bfloat16 (the upstream scores in
  float64), picking the first of equal scores and returning the float32
  row;
- the grid is ``cleanup_samples_per_dim`` points a side on
  ``numpy.linspace`` of the domain, in ``meshgrid``'s xy order;
- the LIF neuron integrates with the spike time interpolated inside the
  step (nengo's reference LIF), every filter is a zero-order-hold one-pole
  lowpass;
- float32 contractions with TF32 off (set here on import).

``tf32=True`` rounds every contraction's operands to TF32 (the control).
Nothing here imports the program; what the program made is read only to
be judged (:mod:`.slam_check`).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import special_ortho_group

from . import ssp, vco

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TAU_RC, TAU_REF = vco.TAU_RC, vco.TAU_REF


# ---------------------------------------------------------------------------
# fixed tables
# ---------------------------------------------------------------------------

def sp_vectors(n: int, d: int, seed: int) -> np.ndarray:
    """The landmarks' semantic pointers: ``n`` unit-sphere draws of the
    legacy ``RandomState(seed)`` (normals, then uniforms), made unitary,
    then each later vector's projection on every earlier one removed."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, d)
    rng.rand(n)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = unitary_np(v)
    for j in range(n):
        q = v[j] / np.linalg.norm(v[j])
        for i in range(j + 1, n):
            v[i] = v[i] - (q @ v[i]) * q
    return v


def unitary_np(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Every Fourier coefficient of each row put on the unit circle."""
    f = np.fft.fft(np.atleast_2d(np.asarray(x, np.float64)), axis=-1)
    f = f / np.maximum(np.abs(f), eps)
    return np.fft.ifft(f, axis=-1).real


def ovc_vectors(n: int, seed: int, offset: float = 0.5) -> np.ndarray:
    """(n, 2) displacements scattered over the unit disc: an R_d
    sequence's first coordinate sets the radius (from a magnitude of 1e-3
    up), its second the angle, then one rotation drawn from
    ``default_rng(seed)``."""
    from benchmark.harness.slam_world import rd_points
    cube = rd_points(n, 2, offset)
    mm = 1e-3 ** 2
    radius = (mm + cube[:, :1] * (1 - mm)) ** 0.5
    ang = 2.0 * np.pi * cube[:, 1]
    pts = np.stack([np.cos(ang), np.sin(ang)], 1) * radius
    return pts @ special_ortho_group.rvs(2, random_state=np.random.
                                         default_rng(seed))


def grid_points(cfg: dict) -> np.ndarray:
    """The clean-up's grid: ``cleanup_samples_per_dim`` points a side over
    the domain, flattened in ``meshgrid``'s xy order."""
    r, m = cfg["domain_bound"], cfg["cleanup_samples_per_dim"]
    axes = np.linspace(-r, r, m)
    gx, gy = np.meshgrid(axes, axes)
    return np.stack([gx.ravel(), gy.ravel()], axis=-1)


def binding_transforms(d: int, invert_a: bool):
    """(tr_a, tr_b, tr_out) of a circular convolution: the half-spectrum
    DFT's rows aligned as four product channels per frequency, [Re a, Im
    a, Re a, Im a] against [Re b, Im b, Im b, Re b], and the inverse DFT
    folding them back (Re = w - x, Im = y + z)."""
    h = d // 2 + 1
    M = np.exp(-2j * np.pi * np.outer(np.arange(h), np.arange(d)) / d)
    re, im = M.real, M.imag
    im_a = -im if invert_a else im
    tr_a = np.zeros((4 * h, d))
    tr_b = np.zeros((4 * h, d))
    tr_a[0::4], tr_a[1::4], tr_a[2::4], tr_a[3::4] = re, im_a, re, im_a
    tr_b[0::4], tr_b[1::4], tr_b[2::4], tr_b[3::4] = re, im, im, re
    c = np.full(h, 2.0)
    c[0] = 1.0
    if d % 2 == 0:
        c[-1] = 1.0
    out = np.zeros((d, 4 * h))
    out[:, 0::4] = c * re.T / d
    out[:, 1::4] = -c * re.T / d
    out[:, 2::4] = c * im.T / d
    out[:, 3::4] = c * im.T / d
    return tr_a, tr_b, out


def _ensemble(rng, n, dim, radius, encoders=None, intercept=None):
    """One ensemble's draws: max rates, intercepts (unless fixed),
    encoders (unless given), evaluation points; its LIF gains, biases and
    encoders scaled by gain / radius."""
    rates = rng.uniform(200.0, 400.0, size=n)
    icepts = (np.full(n, float(intercept)) if intercept is not None
              else rng.uniform(-1.0, 0.9, size=n))
    if encoders is None:
        encoders = vco._sphere(rng, n, dim, surface=True)
    else:
        encoders = encoders / np.maximum(
            np.linalg.norm(encoders, axis=1, keepdims=True), 1e-12)
    gain, bias = vco.lif_gain_bias(rates, icepts)
    return gain, bias, encoders


def _eval_points(rng, n, dim, radius):
    return vco._sphere(rng, vco.n_eval_points(n, dim), dim,
                       surface=False) * radius


def _array(rng, k, n, dim, radius):
    gains, biases, encs = [], [], []
    for _ in range(k):
        g, b, e = _ensemble(rng, n, dim, radius)
        gains.append(g)
        biases.append(b)
        encs.append(e)
    ep = _eval_points(rng, n, dim, radius)
    gain, bias, enc = np.stack(gains), np.stack(biases), np.stack(encs)
    return {"gain": gain, "bias": bias, "encoders": enc,
            "scaled": enc * (gain / radius)[..., None], "ep": ep,
            "radius": radius}


def draws(cfg: dict, seed: int, scale: float) -> dict:
    """Every ensemble's parameters in the builder's stream order, in
    float64 on the host: by name, gains, biases, unit encoders, scaled
    encoders and evaluation points."""
    d, n_mem = cfg["ssp_dim"], cfg["mem_n_neurons"]
    phase = ssp.phase_matrix(cfg["domain_dim"], d)
    ovc_enc = ssp.encode(phase, cfg["length_scale"],
                         ovc_vectors(n_mem, seed))
    master = np.random.default_rng(seed)

    def stream():
        return np.random.default_rng(master.integers(2 ** 31))

    out = {}
    for name, enc, icept in (("ovc", ovc_enc, None), ("recall", None, None),
                             ("memory", None, cfg["intercept"]),
                             ("error", None, None)):
        rng = stream()
        g, b, e = _ensemble(rng, n_mem, d, 1.0, encoders=enc,
                            intercept=icept)
        out[name] = {"gain": g, "bias": b, "encoders": e,
                     "scaled": e * g[:, None], "ep": _eval_points(
                         rng, n_mem, d, 1.0), "radius": 1.0}
    k = (d + 1) // 2
    out["vco"] = _array(stream(), k, cfg["pi_n_neurons"], 3,
                        float(np.sqrt(2.0)))
    channels = 2 * 4 * (d // 2 + 1)
    for name in ("cc1", "cc2"):
        out[name] = _array(stream(), channels,
                           max(1, cfg["circonv_n_neurons"] // 2), 1,
                           float(2 * np.sqrt(2.0)))
    out["phase"], out["scale"] = phase, scale
    return out


def _rates(E, b, ep):
    """LIF rates (k, P, n) of ensembles (k, n, dim) at points (k or 1, P,
    dim)."""
    return vco.lif_rates(torch.einsum("kpc,knc->kpn", ep, E) + b[:, None])


#: decoders the network solves, by name: (ensemble, target)
DECODERS = {"vco.rec": ("vco", "limit_cycle"), "vco.out": ("vco", "id"),
            "cc1.id": ("cc1", "id"), "cc1.sq": ("cc1", "square"),
            "cc2.id": ("cc2", "id"), "cc2.sq": ("cc2", "square"),
            "ovc.id": ("ovc", "id"), "ovc.unit": ("ovc", "unitary"),
            "recall.id": ("recall", "id"),
            "recall.unit": ("recall", "unitary"),
            "error.id": ("error", "id"), "memory.pes": ("memory", "zero")}


def _targets(what, ep, cfg, scale):
    if what == "id":
        return ep
    if what == "square":
        return ep ** 2
    if what == "unitary":
        return unitary_np(ep)
    if what == "zero":
        return np.zeros_like(ep)
    return vco.limit_cycle(ep, cfg["recurrent_tau"], scale,
                           cfg["length_scale"])


def build(cfg: dict, seed: int, scale: float, device, tf32=False) -> dict:
    """The reference network for the configuration, network seed ``seed``
    and velocity scale ``scale``: every table float32 on ``device`` by
    name, the decoders by :data:`DECODERS`' names, and each decoder's
    rates at its evaluation points (``rates``, float64) for judging
    decoders by what they decode."""
    dev = torch.device(device)
    op = vco.round_tf32 if tf32 else (lambda t: t)
    dr = draws(cfg, seed, scale)
    d = cfg["ssp_dim"]

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)

    net = {"cfg": cfg, "tf32": tf32, "device": dev, "d": d}
    rates, dec = {}, {}
    for name in ("ovc", "recall", "memory", "error", "vco", "cc1", "cc2"):
        e = dr[name]
        batched = e["scaled"].ndim == 3
        E = f32(e["scaled"] if batched else e["scaled"][None])
        b = f32(e["bias"] if batched else e["bias"][None])
        ep = f32(e["ep"])[None]
        A = _rates(op(E), b, op(ep))
        if not torch.isfinite(A).all():
            raise FloatingPointError(f"the reference's {name} rates")
        rates[name] = A
        net[name] = {"E": op(E if batched else E[0]),
                     "bias": b if batched else b[0],
                     "gain": f32(e["gain"]), "radius": e["radius"]}
    for key, (name, what) in DECODERS.items():
        A = rates[name]
        Y = f32(_targets(what, dr[name]["ep"], cfg, scale))
        D = vco.l2_decoders(A, Y.expand(A.shape[0], -1, -1), tf32)
        if key == "vco.rec":
            D[0] = 0.0                  # oscillator 0 is held instead
        if what == "zero":
            D = torch.zeros_like(D)
        dec[key] = op(D if A.shape[0] > 1 else D[0])
    net["dec"] = dec
    net["rates"] = {k: rates[v[0]].double() for k, v in DECODERS.items()}
    net["draws"] = dr

    k = (d + 1) // 2
    tr1 = binding_transforms(d, False)
    tr2 = binding_transforms(d, True)
    h4 = tr1[0].shape[0]
    eye = np.eye(h4) / np.sqrt(2.0)
    net["T"] = {
        "to_fourier": op(f32(ssp.to_fourier(d))),
        "from_fourier": op(f32(ssp.from_fourier(d))),
        "vel": op(f32(dr["phase"][:k])),
        "cc1.a": op(f32(tr1[0])), "cc1.b": op(f32(tr1[1])),
        "cc2.a": op(f32(tr2[0])), "cc2.b": op(f32(tr2[1])),
        "cc.out": op(f32(tr1[2])),
        "sq.a": op(f32(np.vstack([eye, eye]))),
        "sq.b": op(f32(np.vstack([eye, -eye]))),
        "sq.out": op(f32(np.hstack([0.5 * np.eye(h4), -0.5 * np.eye(h4)]))),
    }
    pts = grid_points(cfg)
    bank = f32(ssp.encode(dr["phase"], cfg["length_scale"], pts))
    net["bank"], net["bank_sim"] = bank, bank.to(torch.bfloat16)
    net["points"] = pts
    net["gate"] = (float(np.float32(cfg["update_thres"])),
                   float(np.float32(cfg["shift_rate"])))
    dt = cfg["dt"]
    net["a"] = {key: float(np.exp(-dt / cfg[key]))
                for key in ("tau", "recurrent_tau", "memory_tau",
                            "probe_synapse", "pes_synapse")}
    return net


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------

#: the reference's state: neurons (voltage, refractory) by population,
#: synapses by the signal they carry, the learned leaves
NEURONS = ("vco", "ovc", "recall", "memory", "error", "cc1", "cc2")
FILTERS = ("clean", "value", "ovc_unit", "recall_unit", "estimate", "pi",
           "vco_rec", "pes_act", "recall_in", "error_value",
           "error_recall", "pes_error", "probe")
LEARNED = ("pes", "voja")


def at_rest(net: dict) -> dict:
    """The state at rest: neurons and synapses at zero, the PES decoders
    at zero and the Voja encoders at the key population's own."""
    dev, d = net["device"], net["d"]

    def z(*shape):
        return torch.zeros(shape, device=dev)

    s = {}
    for name in NEURONS:
        shape = tuple(net[name]["bias"].shape)
        s[name] = {"voltage": z(*shape), "refractory": z(*shape)}
    k = (d + 1) // 2
    n_mem = net["memory"]["bias"].shape[0]
    for f in FILTERS:
        s[f] = z(k, 3) if f == "vco_rec" else z(n_mem) if f == "pes_act" \
            else z(d)
    s["pes"] = net["dec"]["memory.pes"].clone()
    s["voja"] = net["memory"]["E"].clone()
    return s


def clone(state: dict) -> dict:
    return {k: ({kk: vv.clone() for kk, vv in v.items()}
                if isinstance(v, dict) else v.clone())
            for k, v in state.items()}


def _lif(s, J, dt):
    """One LIF step of state ``s`` (voltage, refractory) under currents
    ``J``: the new state and the spikes (1 / dt where one fell)."""
    ref = s["refractory"] - dt
    delta = torch.clamp(dt - ref, 0.0, dt)
    v = s["voltage"] + (J - s["voltage"]) * -torch.expm1(-delta / TAU_RC)
    spiked = v > 1.0
    denom = torch.where(spiked, torch.clamp(J - 1.0, min=1e-12),
                        torch.ones_like(J))
    over = torch.clamp((v - 1.0) / denom, 0.0, 1.0 - 1e-6)
    t_spike = dt + TAU_RC * torch.log1p(-over)
    act = torch.where(spiked, torch.full_like(v, 1.0 / dt),
                      torch.zeros_like(v))
    new = {"voltage": torch.where(spiked, torch.zeros_like(v),
                                  torch.clamp(v, min=0.0)),
           "refractory": torch.where(spiked, TAU_REF + t_spike, ref)}
    return new, act


def step(net: dict, s: dict, x: dict):
    """One step from state ``s`` with the input row ``x`` (``vel`` (2),
    ``init`` (d), ``vecssp`` (d), ``sp`` (d), ``no_view`` (1)): the new
    state and this step's signals (``pi``: the probe's row, ``recall``,
    ``estimate``, ``clean``)."""
    cfg, dt, d = net["cfg"], net["cfg"]["dt"], net["d"]
    op = vco.round_tf32 if net["tf32"] else (lambda t: t)
    T, dec = net["T"], net["dec"]
    a = net["a"]

    def mv(M, v):
        return op(M) @ op(v)

    def decode(act, D):
        return op(act) @ op(D)

    new = {}
    # the gate: the filtered estimate and PI output, the view signal
    est, pi_f = s["estimate"], s["pi"]
    thr, rate = net["gate"]
    ok = (x["no_view"][0].abs() < 1e-3) & (torch.sum(est * pi_f) > thr)
    corr = torch.where(ok, rate * (est - pi_f), torch.zeros_like(est))
    # the clean-up of the filtered PI output, scored in bfloat16
    sims = torch.einsum("md,d->m", net["bank_sim"],
                        s["clean"].to(net["bank_sim"].dtype))
    clean = net["bank"][torch.argmax(sims)]
    # the key population: Voja's encoders against the landmark's SP
    key = x["sp"]
    mem = net["memory"]
    new["memory"], a_mem = _lif(s["memory"], mv(s["voja"], key)
                                + mem["bias"], dt)
    # the oscillators
    vc = net["vco"]
    k = vc["bias"].shape[0]
    # the inputs in the engine's order: the corrections through the DFT
    # map, the velocity into each omega, the recurrence, the DC hold
    xin = mv(T["to_fourier"], corr + x["init"]).reshape(k, 3)
    xin[:, 2] += mv(T["vel"], x["vel"])
    xin = xin + s["vco_rec"]
    xin[0, 0] += 1.0
    J = torch.einsum("knc,kc->kn", op(vc["E"]), op(xin)) + vc["bias"]
    new["vco"], a_vco = _lif(s["vco"], J, dt)
    osc = torch.einsum("kn,knc->kc", op(a_vco), op(dec["vco.out"]))
    pi = mv(T["from_fourier"], osc.reshape(-1))
    # object-vector cells, recall and error
    new["ovc"], a_ovc = _lif(s["ovc"], mv(net["ovc"]["E"], x["vecssp"])
                             + net["ovc"]["bias"], dt)
    new["recall"], a_rec = _lif(s["recall"], mv(net["recall"]["E"],
                                                s["recall_in"])
                                + net["recall"]["bias"], dt)
    err_in = s["error_value"] + s["error_recall"]
    new["error"], a_err = _lif(
        s["error"], mv(net["error"]["E"], err_in) + net["error"]["bias"]
        - 2.5 * x["no_view"][0], dt)
    # the two circular convolutions
    ovc_vec = decode(a_ovc, dec["ovc.id"])
    outs = {}
    for name, ina, inb in (("cc1", clean, ovc_vec),
                           ("cc2", s["ovc_unit"], s["recall_unit"])):
        pa, pb = mv(T[name + ".a"], ina), mv(T[name + ".b"], inb)
        sq_in = mv(T["sq.a"], pa) + mv(T["sq.b"], pb)
        e = net[name]
        J = e["E"][:, :, 0] * op(sq_in)[:, None] + e["bias"]
        new[name], a_sq = _lif(s[name], J, dt)
        sq = torch.einsum("kn,knc->kc", op(a_sq),
                          op(dec[name + ".sq"]))[:, 0]
        outs[name] = mv(T["cc.out"], mv(T["sq.out"], sq))
    # the synapses, each from this step's value
    a_t, a_r, a_m, a_e = (a["tau"], a["recurrent_tau"], a["memory_tau"],
                          a["pes_synapse"])

    def lp(name, alpha, u):
        new[name] = alpha * s[name] + (1 - alpha) * u

    lp("clean", a_t, pi)
    lp("value", a_t, outs["cc1"])
    lp("ovc_unit", a_t, decode(a_ovc, dec["ovc.unit"]))
    lp("recall_unit", a_t, decode(a_rec, dec["recall.unit"]))
    lp("estimate", a_t, outs["cc2"])
    lp("pi", a_t, pi)
    lp("vco_rec", a_r, torch.einsum("kn,knc->kc", op(a_vco),
                                    op(dec["vco.rec"])))
    lp("pes_act", a_e, a_mem)
    lp("recall_in", a_e, decode(a_mem, s["pes"]))
    lp("error_value", a_m, -s["value"])
    lp("error_recall", a_m, decode(a_rec, dec["recall.id"]))
    lp("pes_error", a_m, decode(a_err, dec["error.id"]))
    # learning: PES from the error of the step before, Voja
    n_mem = s["pes"].shape[0]
    new["pes"] = s["pes"] - (cfg["pes_lr"] * dt / n_mem) * torch.outer(
        new["pes_act"], s["pes_error"])
    signal = 1.0 + x["no_view"][0]
    scale = mem["gain"] / mem["radius"]
    new["voja"] = s["voja"] + cfg["voja_lr"] * dt * signal * (
        scale[:, None] * torch.outer(a_mem, key)
        - a_mem[:, None] * s["voja"])
    lp("probe", a["probe_synapse"], pi)
    return new, {"pi": new["probe"], "recall": new["error_recall"],
                 "estimate": new["estimate"], "clean": clean}


def run(net: dict, state: dict, rows: dict):
    """``state`` advanced over the input rows ``rows`` (each (K, size)):
    (the state after, the probe's rows (K, d))."""
    K = rows["vel"].shape[0]
    out = []
    s = clone(state)
    for i in range(K):
        s, sig = step(net, s, {k: v[i] for k, v in rows.items()})
        out.append(sig["pi"])
    return s, torch.stack(out)
