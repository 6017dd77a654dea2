"""bf16 matmul-input drift study on the port: the flags and printed lines
of the JAX package's ``experiments/bf16_drift.py``, with ``--device``
(default ``cuda``) in place of ``--cpu``.

``Simulator(matmul_dtype="bf16")`` rounds the *inputs* of the large
per-step matmuls (the encoders / decoders / transforms and the activities
they contract with) to bfloat16 and keeps float32 accumulation, state and
filters.  The path integrator is a bank of VCO limit cycles whose phase is
integrated for 1e4-1e5 steps, so precision errors could accumulate as
phase drift rather than wash out.  The same built PI model (reference
run_pathint defaults) runs in float32 and bf16 over a long horizon; the
study compares the decoded path error of each against ground truth and
the direct divergence between the two trajectories, and times both (the
graphs of each are captured before its timed run).

    python -m sspslam_tpu_torch.experiments.bf16_drift [--T 60] \
        [--device cpu]
"""

import argparse
import time

import numpy as np

from ..models import PathIntegration
from ..nef import (Connection, Network, Node, Probe, Simulator, TimeTable,
                   WhiteSignal)
from ..sspspace import HexagonalSSPSpace
from .common import DT, decode_output


def run_once(model, probe, T, seed, matmul_dtype, segment_steps, device):
    """``model`` built with ``matmul_dtype`` and run ``T`` seconds in
    segments of ``segment_steps`` (graphs captured first); returns the
    probe's trace and the run's seconds."""
    n = int(T / DT)
    sim = Simulator(model, seed=seed, matmul_dtype=matmul_dtype,
                    progress=False, device=device)
    sim.preload_inputs(n)
    sim.compile(n, segment_steps=segment_steps)
    t0 = time.time()
    sim.run_steps(n, segment_steps=segment_steps)
    sim.sync()
    elapsed = time.time() - t0
    return sim.data[probe], elapsed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=float, default=60.0)
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--limit", type=float, default=0.1)
    ap.add_argument("--segment-steps", type=int, default=2000)
    ap.add_argument("--device", default="cuda",
                    help="torch device the simulation runs on (cuda | cpu)")
    args = ap.parse_args(argv)

    dt = DT
    radius = 1.0
    n_steps = int(args.T / dt)
    sig = WhiteSignal(args.T + 1, high=args.limit, rms=0.3, seed=args.seed)
    vels = sig.run(args.T + 1, dt=dt, size_out=2)[: n_steps]
    path = np.cumsum(vels * dt, axis=0)
    path = 0.9 * radius * path / max(1.0, np.max(np.abs(path)))
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])

    bounds = 1.1 * radius * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=args.seed,
                              length_scale=0.2, domain_bounds=bounds)
    d = space.ssp_dim
    scale_fac = 1 / np.max(np.abs(space.phase_matrix @ vels.T))
    init = space.encode(path[:1]).flatten()

    with Network(seed=args.seed) as model:
        vel = Node(TimeTable(vels * scale_fac, dt))
        init_node = Node(lambda t: init if t < 0.05 else np.zeros(d))
        pi = PathIntegration(space, args.pi_n_neurons, 0.05,
                             scaling_factor=scale_fac, stable=True)
        Connection(vel, pi.velocity_input, synapse=None)
        Connection(init_node, pi.input, synapse=None)
        p = Probe(pi.output, synapse=0.05)

    out32, t32 = run_once(model, p, args.T, args.seed, None,
                          args.segment_steps, args.device)
    out16, t16 = run_once(model, p, args.T, args.seed, "bf16",
                          args.segment_steps, args.device)

    skip = max(1, n_steps // 4000)
    path_s = path[: out32.shape[0]][::skip]
    est32 = decode_output(space, out32[::skip], 2, grid=100,
                          device=args.device)
    est16 = decode_output(space, out16[::skip], 2, grid=100,
                          device=args.device)
    err32 = np.sqrt(np.sum((path_s - est32) ** 2, axis=1))
    err16 = np.sqrt(np.sum((path_s - est16) ** 2, axis=1))
    # direct SSP-trajectory divergence (cosine between the two runs)
    n1 = np.maximum(np.linalg.norm(out32[::skip], axis=1), 1e-6)
    n2 = np.maximum(np.linalg.norm(out16[::skip], axis=1), 1e-6)
    cos = np.sum(out32[::skip] * out16[::skip], axis=1) / (n1 * n2)

    q = n_steps // skip // 4
    print(f"config: ssp_dim={d}, {args.pi_n_neurons} LIF/VCO, T={args.T}s "
          f"({n_steps} steps)")
    print(f"f32  : median err {np.median(err32):.3f}  "
          f"last-quarter {np.median(err32[-q:]):.3f}  final {err32[-1]:.3f}"
          f"  ({n_steps / t32:.0f} steps/s)")
    print(f"bf16 : median err {np.median(err16):.3f}  "
          f"last-quarter {np.median(err16[-q:]):.3f}  final {err16[-1]:.3f}"
          f"  ({n_steps / t16:.0f} steps/s)")
    print(f"bf16 speedup: {t32 / t16:.2f}x")
    print(f"f32-vs-bf16 trajectory cosine: median {np.median(cos):.4f}  "
          f"min {np.min(cos):.4f}  final {cos[-1]:.4f}")
    return {"err32": err32, "err16": err16, "cos": cos,
            "steps_per_s": (n_steps / t32, n_steps / t16)}


if __name__ == "__main__":
    main()
