"""Back-to-back path-integration episodes through ``FastPathIntegrator.run``
(the VCO bank in one kernel launch per chunk of ``chunk_steps`` steps).

Each episode starts the bank from rest on its own band-limited path, with
the initial-position clamp over its first 50 ms, and its whole trace is
brought to the host, as ``run_pathint`` keeps it.  The paths are made at
set-up: ``pool`` of them from the seed's streams, the episodes of the
window taking them in turn.  A unit of the window is one episode.

The check: one episode of the window, drawn from the seed, with the state
the program carried across each of its chunk boundaries (read from
``FastPathIntegrator.state`` as ``run`` assigns it: no copy, no wait).
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import counts
from benchmark.harness import world as W

def setup(ctx):
    with ctx.spans.span("import"):
        import sspslam_tpu_torch as port
    cfg, mix = ctx.cfg, ctx.mix
    ms = W.model_seed(ctx.seed)
    with ctx.spans.span("traffic"):
        paths = [W.pi_episode(mix, ctx.seed, e) for e in range(mix["pool"])]
    clamp = int(round(cfg["clamp_s"] / cfg["dt"])) - 1

    class Recorded(port.models.FastPathIntegrator):
        """The program's integrator; each state ``run`` carries from one
        launch to the next is also appended to ``record``."""
        record = None

        @property
        def state(self):
            return self._state

        @state.setter
        def state(self, s):
            self._state = s
            if self.record is not None:
                self.record.append(s)

    with ctx.spans.span("build"):
        n = cfg["domain_dim"]
        space = port.sspspace.HexagonalSSPSpace(
            n, ssp_dim=cfg["ssp_dim"], seed=ms,
            length_scale=cfg["length_scale"],
            domain_bounds=cfg["domain_bound"] * np.tile([-1.0, 1.0], (n, 1)))
        # run_pathint's 1 / max |A v|, from the run's first path
        scale = float(1.0 / np.max(np.abs(space.phase_matrix
                                          @ paths[0][1].T)))
        fpi = Recorded(
            space, cfg["pi_n_neurons"], cfg["recurrent_tau"],
            scaling_factor=scale, tau_probe=cfg["probe_synapse"], seed=ms,
            chunk_steps=mix["chunk_steps"], dt=cfg["dt"],
            device=ctx.device)
    with ctx.spans.span("warmup"):
        vels = [np.asarray(v * scale, np.float32) for _, v in paths]
        heads = [np.asarray(space.encode(p[:clamp]), np.float32)
                 for p, _ in paths]
        corr = np.zeros((vels[0].shape[0], space.ssp_dim), np.float32)
        # the kernel's build (the first run in a checkout) and its first
        # launches
        fpi.run(vels[0][:mix["chunk_steps"]], corr[:mix["chunk_steps"]])
    rng = np.random.default_rng([int(ctx.seed), 1 << 20])
    return {"fpi": fpi, "vels": vels, "heads": heads, "corr": corr,
            "clamp": clamp, "done": 0,
            "pick": int(rng.integers(mix["check_within"])), "kept": None}


def trace_units(ctx) -> int:
    return ctx.mix["trace_episodes"]


def unit(ctx, st):
    e = st["done"]
    i = e % ctx.mix["pool"]
    st["corr"][:st["clamp"]] = st["heads"][i]
    fpi = st["fpi"]
    with ctx.spans.span("episode"):
        fpi.record = []
        fpi.state = fpi.initial_state()
        trace = fpi.run(st["vels"][i], st["corr"])
    if e <= st["pick"]:
        st["kept"] = (e, i, trace, fpi.record)
    fpi.record = None
    st["done"] += 1
    return trace.shape[0]


def flops_per_step(ctx):
    """The VCO bank's operations a simulated step, from the chunk counts
    and the reference's spikes (None before the check has counted)."""
    c = ctx.counts
    if "chunk_spikes" not in c:
        return None
    spikes = sum(c["chunk_spikes"]) / len(c["chunk_spikes"])
    return counts.vco_chunk(c["n"], c["k"], c["d"], c["N"], c["T"],
                            spikes)["flops"] / c["T"]


def program_outputs(ctx, st):
    from benchmark.reference import check, vco
    ctx.window["attempted"] = st["done"]
    e, i, trace, record = st["kept"]
    p = st["fpi"].params
    names = vco.TABLES + sum(vco.DECODERS.values(), ())
    # record: the state at rest, then the state after each launch
    return {"episode": e, "path": i, "trace": trace,
            "tables": {k: check.host(getattr(p, k)) for k in names},
            "states": [s._asdict() for s in record[1:-1]],
            "chunk": ctx.mix["chunk_steps"]}


def reference_check(ctx, out):
    from benchmark.reference import pi
    pi.check_episode(ctx, out)


def readings(cfg, mix, seed, device, out):
    """The program's and the control's compared numbers (the control's
    script)."""
    from benchmark.reference import pi
    return pi.readings(cfg, mix, seed, device, out)
