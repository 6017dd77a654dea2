"""Fine-tune the path integrator's recurrent decoders by backprop through
the simulation (``sspslam_tpu_torch.train``): the flags, printed lines and
npz keys of the JAX package's ``experiments/train_pathint.py``, with
``--device`` (default ``cuda``) in place of ``--cpu``.

The VCO limit-cycle decoders solved by LstsqL2 approximate the oscillator
feedback from sampled eval points; backprop through the closed-loop
episode refines them against the SSP tracking error under recurrent
dynamics, and the refinement generalises to a held-out trajectory.

    python -m sspslam_tpu_torch.experiments.train_pathint [--device cpu] \
        --ssp-dim 31 --pi-n-neurons 60 --T-steps 600 --fit-steps 60

Prints before/after tracking error on the training world and a held-out
world, and with ``--save`` writes an npz.
"""

import argparse
import os
import time

import numpy as np
import torch

from .. import HexagonalSSPSpace, train
from ..models import PathIntegration
from ..nef import (Connection, LIFRate, Network, Node, Probe, Simulator,
                   SurrogateLIF, TimeTable, clamp_table)


def make_world(seed, n_steps, dt):
    """Smooth random path from a low-frequency Fourier mix."""
    rng = np.random.default_rng(seed)
    ts = dt * np.arange(n_steps)
    total = n_steps * dt
    path = np.zeros((n_steps, 2))
    for i in range(2):
        for f in (1, 2, 3):
            path[:, i] += (rng.normal() * np.sin(2 * np.pi * f * ts / total)
                           + rng.normal() * np.cos(2 * np.pi * f * ts / total))
    path -= path[0]
    path *= 0.5 / max(np.abs(path).max(), 1e-9)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    return path, vels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ssp-dim", type=int, default=31)
    ap.add_argument("--pi-n-neurons", type=int, default=60)
    ap.add_argument("--T-steps", type=int, default=600)
    ap.add_argument("--segment-steps", type=int, default=100,
                    help="checkpoint (remat) granularity")
    ap.add_argument("--fit-steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-world-seed", type=int, default=1)
    ap.add_argument("--test-world-seed", type=int, default=7)
    ap.add_argument("--neuron-type", default="lifrate",
                    choices=["lifrate", "surrogate"],
                    help="lifrate: smooth rate gradients; surrogate: "
                         "spiking forward with surrogate spike gradients")
    ap.add_argument("--device", default="cuda",
                    help="torch device the episodes run on (cuda | cpu)")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--save-dir", default="data")
    args = ap.parse_args(argv)

    dt = 0.001
    n_steps = args.T_steps
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=args.seed,
                              length_scale=0.3,
                              domain_bounds=1.2 * np.tile([-1, 1.0], (2, 1)))
    path_tr, vels_tr = make_world(args.train_world_seed, n_steps, dt)
    path_te, vels_te = make_world(args.test_world_seed, n_steps, dt)
    scale_fac = 1 / max(np.max(np.abs(space.phase_matrix @ vels_tr.T)),
                        np.max(np.abs(space.phase_matrix @ vels_te.T)))
    nt = LIFRate() if args.neuron_type == "lifrate" else SurrogateLIF()

    def build(vels, path):
        ssp0 = space.encode(path[:1]).flatten()
        with Network(seed=args.seed) as net:
            vel = Node(TimeTable((vels * scale_fac).astype(np.float32), dt))
            init = Node(clamp_table(ssp0, 0.05, dt))
            pi = PathIntegration(space, args.pi_n_neurons, 0.05,
                                 scaling_factor=scale_fac, neuron_type=nt)
            Connection(vel, pi.velocity_input, synapse=None)
            Connection(init, pi.input, synapse=None)
            p = Probe(pi.output, synapse=0.02)
        return Simulator(net, seed=args.seed, device=args.device), p, pi

    sim, probe, pi = build(vels_tr, path_tr)
    device = sim.device
    targ_tr = space.encode(path_tr).astype(np.float32)
    targ_te = space.encode(path_te).astype(np.float32)

    episode = train.make_episode_fn(sim, n_steps,
                                    segment_steps=args.segment_steps)
    xs_tr = train.episode_inputs(sim, n_steps)
    pidx = train.probe_index(sim, probe)
    rec_path = train.connection_param_path(sim, pi.recurrent)
    # same model and seed, another world: only the input table changes
    sim_te, _, _ = build(vels_te, path_te)
    xs_te = train.episode_inputs(sim_te, n_steps)
    del sim_te

    settle = min(100, n_steps // 4)
    mask = torch.as_tensor(
        (np.arange(n_steps) >= settle).astype(np.float32)[:, None],
        device=device)
    targ_tr_t = torch.as_tensor(targ_tr, device=device)

    def loss_fn(emits, final_state):
        return torch.sum(mask * (emits[pidx] - targ_tr_t) ** 2) \
            / torch.sum(mask)

    def cos_err(params, xs, targ):
        """mean(1 - cosine(output, encode(true pos))) over the last half."""
        with torch.no_grad():
            _, emits = episode(params, xs, sim.model.initial_state())
        out = emits[pidx].cpu().numpy()
        u = out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)
        v = targ / np.maximum(np.linalg.norm(targ, axis=1, keepdims=True),
                              1e-9)
        return float(np.mean((1 - np.sum(u * v, axis=1))[n_steps // 2:]))

    e0_tr = cos_err(sim.params, xs_tr, targ_tr)
    e0_te = cos_err(sim.params, xs_te, targ_te)
    print(f"lstsq-solved:  train-world err {e0_tr:.4f}   "
          f"held-out err {e0_te:.4f}")

    t0 = time.time()
    params2, losses = train.fit(
        episode, sim.params, xs_tr, sim.model.initial_state(), loss_fn,
        trainable=lambda s: s == rec_path,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=args.lr),
        steps=args.fit_steps, keep_best=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    el = time.time() - t0
    print(f"fit: {args.fit_steps} steps in {el:.1f}s  "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if device.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MiB")

    e1_tr = cos_err(params2, xs_tr, targ_tr)
    e1_te = cos_err(params2, xs_te, targ_te)
    print(f"backprop-tuned: train-world err {e1_tr:.4f}   "
          f"held-out err {e1_te:.4f}")
    print(f"held-out improvement: {100 * (1 - e1_te / max(e0_te, 1e-9)):.1f}%")

    if args.save:
        os.makedirs(args.save_dir, exist_ok=True)
        fname = os.path.join(
            args.save_dir,
            f"trainpi_sspdim_{space.ssp_dim}_pinneurons_{args.pi_n_neurons}"
            f"_Tsteps_{n_steps}_fit_{args.fit_steps}_seed_{args.seed}.npz")
        np.savez(fname, losses=np.asarray(losses),
                 err_before=[e0_tr, e0_te], err_after=[e1_tr, e1_te],
                 fit_time=el, lr=args.lr,
                 neuron_type=args.neuron_type)
        print("saved", fname)


if __name__ == "__main__":
    main()
