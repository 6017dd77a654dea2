"""The fast path's reference: the VCO bank of a path integrator, drawn and
solved from the published NEF semantics, and its scan, in plain PyTorch.

The bank (Dumont et al. 2023, the path integrator of ``run_pathint.py``)
is ``k = (d + 1) // 2`` ensembles of ``n`` LIF neurons, each representing
an oscillator's (Re, Im, omega) on a ball of radius sqrt(2).  Per
ensemble, in order, from one stream: max rates uniform on [200, 400) Hz,
x-intercepts uniform on [-1, 0.9), encoders uniform on the sphere; then
the evaluation points, uniform in the ball, shared by the ensembles.  The
stream is seeded as the program's builder seeds an ensemble array, from
the first draw of ``default_rng(seed)``, and a sphere draw takes its
normals and then ``n`` uniforms.  Gains and biases are the LIF ones
(tau_rc 20 ms, tau_ref 2 ms); decoders are the L2-regularised least
squares of the rates at the evaluation points (sigma = 0.1 of the
ensemble's largest rate), solved by Cholesky in float32: the recurrent
ones for the limit cycle ``tau f(x) + x`` (the DC oscillator's zero), the
output ones for the identity.

The tables are laid out as the program's kernel takes them ((n, k) per
component, (d, k) / (k, d) projections), so the program's derived tables
can be held to them by name.  With ``tf32`` every operand of a
contraction is rounded to TF32 first: the control.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ssp

TAU_RC, TAU_REF = 0.02, 0.002
RADIUS = float(np.sqrt(2.0))
REG = 0.1

#: the program's fields this module derives again, elementwise tables
TABLES = ("enc0", "enc1", "enc2", "bias", "velT_T", "tf0T", "tf1T",
          "ts0T", "ts1T")
#: and decoders, by the connection they make
DECODERS = {"drec": ("drec0", "drec1", "drec2"), "dout": ("dout0", "dout1")}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def n_eval_points(n: int, dim: int) -> int:
    return max(int(np.clip(500 * dim, 750, 2500)), 2 * n)


def _sphere(rng, count, dim, surface):
    x = rng.standard_normal((count, dim))
    u = rng.random(count)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x if surface else x * (u ** (1.0 / dim))[:, None]


def draws(seed: int, k: int, n: int, dim: int = 3):
    """(max rates (k, n), intercepts (k, n), encoders (k, n, dim),
    evaluation points (P, dim) on the unit ball)."""
    master = np.random.default_rng(seed)
    rng = np.random.default_rng(master.integers(2 ** 31))
    rates, icepts, encs = [], [], []
    for _ in range(k):
        rates.append(rng.uniform(200.0, 400.0, size=n))
        icepts.append(rng.uniform(-1.0, 0.9, size=n))
        encs.append(_sphere(rng, n, dim, surface=True))
    ep = _sphere(rng, n_eval_points(n, dim), dim, surface=False)
    return np.stack(rates), np.stack(icepts), np.stack(encs), ep


def lif_gain_bias(max_rates, intercepts):
    z = 1.0 / (1.0 - np.exp((TAU_REF - 1.0 / max_rates) / TAU_RC))
    gain = (z - 1.0) / (1.0 - intercepts)
    return gain, 1.0 - gain * intercepts


def lif_rates(J: torch.Tensor) -> torch.Tensor:
    above = J > 1.0
    safe = torch.where(above, J - 1.0, torch.ones_like(J))
    r = 1.0 / (TAU_REF + TAU_RC * torch.log1p(1.0 / safe))
    return torch.where(above, r, torch.zeros_like(J))


def limit_cycle(ep: np.ndarray, tau: float, scale: float, ls: float,
                max_radius: float = 1.0) -> np.ndarray:
    """The recurrent targets: tau * (the Hopf oscillator's derivative at
    frequency omega / (scale ls)) + x, with the omega target 0."""
    x0, x1, x2 = ep[:, 0], ep[:, 1], ep[:, 2]
    w = x2 / (scale * ls)
    r = np.maximum(np.sqrt(x0 ** 2 + x1 ** 2), 1e-9)
    d0 = x0 * (max_radius ** 2 - r ** 2) / r - x1 * w
    d1 = x1 * (max_radius ** 2 - r ** 2) / r + x0 * w
    return np.stack([tau * d0 + x0, tau * d1 + x1, np.zeros_like(x0)], 1)


def l2_decoders(A: torch.Tensor, Y: torch.Tensor, tf32: bool):
    """Decoders (k, n, c) minimising |A D - Y|^2 + P sigma^2 |D|^2 per
    ensemble, sigma = REG x the ensemble's largest rate."""
    op = round_tf32 if tf32 else (lambda t: t)
    P, n = A.shape[1], A.shape[2]
    sigma = REG * A.amax(dim=(1, 2))
    At = op(A).transpose(1, 2)
    G = At @ op(A) + (P * sigma ** 2)[:, None, None] * torch.eye(
        n, dtype=A.dtype, device=A.device)
    return torch.cholesky_solve(At @ op(Y), torch.linalg.cholesky(G))


def bank(cfg: dict, seed: int, scale: float, device, tf32=False) -> dict:
    """The reference's VCO bank for the configuration ``cfg``, network
    seed ``seed`` and velocity scale ``scale``: its tables (float32 on
    ``device``, by the program's names), its rates at the evaluation
    points ``A`` (k, P, n) and the LIF constants."""
    d, N = cfg["ssp_dim"], cfg["domain_dim"]
    n, k = cfg["pi_n_neurons"], (cfg["ssp_dim"] + 1) // 2
    op = round_tf32 if tf32 else (lambda t: t)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    rates, icepts, enc, ep = draws(seed, k, n)
    gain, bias = lif_gain_bias(rates, icepts)
    scaled = enc * (gain / RADIUS)[..., None]                 # (k, n, 3)
    ep = ep * RADIUS
    E, epf = op(f32(scaled)), op(f32(ep))
    A = lif_rates(torch.einsum("pc,knc->kpn", epf, E)
                  + f32(bias)[:, None, :])
    A64 = A.double()
    if not torch.isfinite(A).all():
        raise FloatingPointError("the reference's rates are not finite")
    drec = l2_decoders(A, f32(limit_cycle(
        ep, cfg["recurrent_tau"], scale, cfg["length_scale"]))
        .expand(k, -1, -1), tf32)
    drec[0] = 0.0                    # the DC oscillator is pinned instead
    dout = l2_decoders(A, f32(ep).expand(k, -1, -1), tf32)
    A_ = ssp.phase_matrix(N, d)
    tof, fromf = ssp.to_fourier(d), ssp.from_fourier(d)
    t = {f"enc{c}": E[:, :, c].T for c in range(3)}
    t["bias"] = f32(bias).T
    t.update({f"drec{c}": op(drec[:, :, c].T) for c in range(3)})
    t.update({f"dout{c}": op(dout[:, :, c].T) for c in range(2)})
    t["velT_T"] = op(f32(A_[:k].T))
    t["tf0T"], t["tf1T"] = op(f32(tof[0::3].T)), op(f32(tof[1::3].T))
    t["ts0T"], t["ts1T"] = op(f32(fromf[:, 0::3].T)), op(f32(fromf[:, 1::3].T))
    t = {name: v.contiguous() for name, v in t.items()}
    t.update(A=A64, phase=A_, tau_rc=TAU_RC, tau_ref=TAU_REF, tf32=tf32)
    return t


def at_rest(n: int, k: int, device) -> dict:
    z = torch.zeros
    return {"voltage": z((n, k), device=device),
            "refractory": z((n, k), device=device),
            "f0": z((1, k), device=device), "f1": z((1, k), device=device),
            "f2": z((1, k), device=device),
            "fout": z((1, 2 * k), device=device)}


def scan(tables: dict, vel: np.ndarray, corr: np.ndarray, *,
         recurrent_tau: float, tau_probe: float, dt: float = 0.001,
         state: dict = None, device="cpu", graph_steps: int = 100):
    """The bank from ``state`` (default: at rest) over the velocity rows
    ``vel`` (T, N) with SSP corrections ``corr`` (T, d).  Returns (the
    filtered SSP trace (T, d) as a float64 array, the spikes of each step
    (T,), the state after).  On a CUDA device the step loop is replayed
    from a captured graph of ``graph_steps`` steps after its first
    ``graph_steps`` steps run eagerly."""
    device = torch.device(device)
    op = round_tf32 if tables["tf32"] else (lambda x: x)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    T = vel.shape[0]
    n, k = tables["bias"].shape
    enc = [tables[f"enc{i}"] for i in range(3)]
    drec = [tables[f"drec{i}"] for i in range(3)]
    dout = [tables[f"dout{i}"] for i in range(2)]
    bias = tables["bias"]
    xc0 = op(t(corr)) @ tables["tf0T"]
    xc1 = op(t(corr)) @ tables["tf1T"]
    xv = op(t(vel)) @ tables["velT_T"]
    proj = torch.cat([tables["ts0T"], tables["ts1T"]])
    a_rec = float(np.exp(-dt / recurrent_tau))
    a_out = float(np.exp(-dt / tau_probe))
    tau_rc, tau_ref = tables["tau_rc"], tables["tau_ref"]
    dc = torch.zeros((1, k), device=device)
    dc[0, 0] = 1.0
    s = {key: v.detach().to(device, torch.float32).clone()
         for key, v in (state or at_rest(n, k, device)).items()}
    v, ref = s["voltage"], s["refractory"]
    f = [s["f0"], s["f1"], s["f2"]]
    fout = s["fout"]
    rows = torch.zeros((T, 2 * k), device=device)
    spikes = torch.zeros(T, dtype=torch.int64, device=device)
    idx = torch.zeros(1, dtype=torch.long, device=device)

    def step():
        x0 = op(f[0] + xc0.index_select(0, idx) + dc)
        x1 = op(f[1] + xc1.index_select(0, idx))
        x2 = op(f[2] + xv.index_select(0, idx))
        J = enc[0] * x0 + enc[1] * x1 + enc[2] * x2 + bias
        # LIF with the spike time interpolated inside the step
        r = ref - dt
        delta = torch.clamp(dt - r, 0.0, dt)
        vv = v + (J - v) * -torch.expm1(-delta / tau_rc)
        spiked = vv > 1.0
        denom = torch.where(spiked, torch.clamp(J - 1.0, min=1e-12),
                            torch.ones_like(J))
        over = torch.clamp((vv - 1.0) / denom, 0.0, 1.0 - 1e-6)
        t_spike = dt + tau_rc * torch.log1p(-over)
        act = torch.where(spiked, 1.0 / dt, 0.0)
        v.copy_(torch.where(spiked, torch.zeros_like(vv),
                            torch.clamp(vv, min=0.0)))
        ref.copy_(torch.where(spiked, tau_ref + t_spike, r))
        spikes.index_copy_(0, idx, spiked.sum().reshape(1))
        for j in range(3):
            dec = torch.sum(act * drec[j], dim=0, keepdim=True)
            f[j].copy_(a_rec * f[j] + (1 - a_rec) * dec)
        out = torch.cat([torch.sum(act * D, dim=0, keepdim=True)
                         for D in dout], dim=1)
        fout.copy_(a_out * fout + (1 - a_out) * out)
        rows.index_copy_(0, idx, fout)
        idx.add_(1)

    done = 0
    if device.type == "cuda" and T >= 2 * graph_steps:
        for _ in range(graph_steps):
            step()
        done = graph_steps
        torch.cuda.synchronize(device)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(graph_steps):
                step()
        while done + graph_steps <= T:
            g.replay()
            done += graph_steps
    for _ in range(T - done):
        step()
    trace = op(rows) @ proj
    after = {"voltage": v, "refractory": ref, "f0": f[0], "f1": f[1],
             "f2": f[2], "fout": fout}
    return trace.to("cpu", torch.float64).numpy(), spikes.cpu().numpy(), \
        after
