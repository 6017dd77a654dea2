"""Gradient-tune the SLAM loop closure by backprop through a full episode:
the flags and printed lines of the JAX package's
``experiments/train_slam.py``, with ``--device`` (default ``cuda``) in
place of ``--cpu``.

The sweep (``tune_loop_closure``) explores the loop-closure settings by
grid; here the same params (the gate's hoisted ``shift_rate`` and the PES /
Voja learning rates read inside the step's weight updates) are tuned by
GRADIENT through the whole SLAMNetwork episode (path integrator,
associative memory, binding, gated correction), with checkpointed
segments.  ``update_thres`` sits behind a hard comparison (zero gradient)
and stays with the sweep.  Rate neurons throughout: hard LIF thresholds
would zero every gradient path.

    python -m sspslam_tpu_torch.experiments.train_slam --device cpu --T 4 \
        --ssp-dim 31 --pi-n-neurons 50 --mem-n-neurons 120 --cc-n-neurons 30

prints the tuned scalars and before/after tracking error on the training
world and a held-out world (same model, another path and landmarks), and,
beyond the JAX CLI's lines, the first meta-step's gradient.
"""

import argparse
import os
import time

import numpy as np
import torch

from .. import train
from ..nef import LIFRate
from .common import decode_output
from .tune_loop_closure import build_sim, make_world, slam_of


class NonNegativeAdam(torch.optim.Adam):
    """Adam followed by ``optax.keep_params_nonnegative``: a coordinate
    the step would make negative becomes 0; the moments are left alone.
    ``first_grads`` keeps the first step's gradients by parameter storage
    (``data_ptr``)."""

    first_grads = None

    @torch.no_grad()
    def step(self, closure=None):
        if self.first_grads is None:
            self.first_grads = {p.data_ptr(): p.grad.clone()
                                for group in self.param_groups
                                for p in group["params"]
                                if p.grad is not None}
        loss = super().step(closure)
        for group in self.param_groups:
            for p in group["params"]:
                p.clamp_(min=0.0)
        return loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=float, default=4.0)
    ap.add_argument("--ssp-dim", type=int, default=31)
    ap.add_argument("--pi-n-neurons", type=int, default=50)
    ap.add_argument("--mem-n-neurons", type=int, default=120)
    ap.add_argument("--cc-n-neurons", type=int, default=30)
    ap.add_argument("--n-landmarks", type=int, default=10)
    ap.add_argument("--view-rad", type=float, default=0.3)
    ap.add_argument("--segment-steps", type=int, default=200)
    ap.add_argument("--fit-steps", type=int, default=12)
    ap.add_argument("--lr", type=float, default=3e-2,
                    help="meta learning rate (multiplicative scale on the "
                         "O(1e-1) gate scalar; lrs move via their own "
                         "adam coordinates)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-world-seed", type=int, default=1)
    ap.add_argument("--test-world-seed", type=int, default=9)
    ap.add_argument("--device", default="cuda",
                    help="torch device the episodes run on (cuda | cpu)")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--save-dir", default="data")
    args = ap.parse_args(argv)

    cfg = dict(update_thres=0.5, shift_rate=0.1, voja_lr=5e-4,
               pes_lr=1e-2, intercept=None)

    def world_and_sim(world_seed):
        world = make_world(args.T, world_seed,
                           n_landmarks=args.n_landmarks,
                           view_rad=args.view_rad, ssp_dim=args.ssp_dim)
        # rate neurons: hard LIF thresholds would zero every gradient path
        sim, probe = build_sim(world, cfg, args.seed,
                               pi_n=args.pi_n_neurons,
                               mem_n=args.mem_n_neurons,
                               cc_n=args.cc_n_neurons,
                               default_neuron_type=LIFRate(),
                               device=args.device)
        return world, sim, probe

    world_tr, sim, probe = world_and_sim(args.train_world_seed)
    world_te, sim_te, _ = world_and_sim(args.test_world_seed)
    device = sim.device
    space = world_tr["space"]
    n_steps = world_tr["n_steps"]
    targ = torch.as_tensor(space.encode(world_tr["path"]).astype(np.float32),
                           device=device)

    episode = train.make_episode_fn(sim, n_steps,
                                    segment_steps=args.segment_steps)
    xs_tr = train.episode_inputs(sim, n_steps)
    xs_te = train.episode_inputs(sim_te, n_steps)
    # each world's adapter scales velocities by ITS 1/max|A·v| factor, but
    # the held-out episode runs through the TRAIN-world model: rebase the
    # test table's velocity columns (the only domain_dim-wide input) onto
    # the train scale
    scale_tr, scale_te = world_tr["fns"][1], world_te["fns"][1]
    splits = sim_te.input_splits
    widths = [n.size_out for n in sim_te.model.input_nodes]
    (va, vb), = [(a, b) for (a, b), w in zip(splits, widths) if w == 2]
    xs_te = np.array(xs_te)
    xs_te[:, va:vb] *= scale_tr / scale_te
    del sim_te
    pidx = train.probe_index(sim, probe)

    slam = slam_of(sim)
    paths = {train.learning_rate_path(sim, slam.assomemory.conn_out): "pes_lr",
             train.learning_rate_path(sim, slam.assomemory.conn_in): "voja_lr"}
    hkey = next(k for k, v in sim.model.hoisted.items() if "shift_rate" in v)
    paths[f"hoisted/{hkey}/shift_rate"] = "shift_rate"

    def trainable(s):
        return s in paths

    settle = n_steps // 4
    mask = torch.as_tensor(
        (np.arange(n_steps) >= settle).astype(np.float32)[:, None],
        device=device)

    def loss_fn(emits, final_state):
        return torch.sum(mask * (emits[pidx] - targ) ** 2) / torch.sum(mask)

    def tracking_err(params, xs, world):
        with torch.no_grad():
            _, emits = episode(params, xs, sim.model.initial_state())
        out = emits[pidx].cpu().numpy()
        skip = max(1, n_steps // 1000)
        est = decode_output(world["space"], out[::skip], 2, grid=60,
                            device=device)
        err = np.sqrt(np.sum((world["path"][::skip] - est) ** 2, axis=1))
        return float(np.median(err[len(err) // 4:]))

    def report(params, tag):
        e_tr = tracking_err(params, xs_tr, world_tr)
        e_te = tracking_err(params, xs_te, world_te)
        print(f"{tag}: train-world median err {e_tr:.3f}   "
              f"held-out {e_te:.3f}")
        return e_tr, e_te

    def scalars(params):
        return {paths[s]: float(leaf)
                for s, leaf in train._leaves_with_paths(params)
                if s in paths}

    print("trainable:", scalars(sim.params))
    e0 = report(sim.params, "swept defaults ")

    t0 = time.time()
    # learning rates must stay non-negative (a negative PES rate unlearns);
    # keep_best guards against the rough meta-landscape: the returned
    # params are the best-loss iterate, not the last
    opts = []

    def optimizer(ps):
        opts.append(NonNegativeAdam(ps, lr=args.lr))
        return opts[-1]
    params2, losses = train.fit(
        episode, sim.params, xs_tr, sim.model.initial_state(), loss_fn,
        trainable=trainable, optimizer=optimizer,
        steps=args.fit_steps, keep_best=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    el = time.time() - t0
    print(f"fit: {args.fit_steps} meta-steps in {el:.1f}s  "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if device.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MiB")
    print("tuned:    ", scalars(params2))
    if opts and opts[0].first_grads is not None:
        # fit's leaves share their storage with params2's
        print("first meta-gradient:", {
            paths[s]: float(opts[0].first_grads[leaf.data_ptr()])
            for s, leaf in train._leaves_with_paths(params2) if s in paths})
    e1 = report(params2, "gradient-tuned")

    if args.save:
        os.makedirs(args.save_dir, exist_ok=True)
        fname = os.path.join(
            args.save_dir,
            f"trainslam_sspdim_{space.ssp_dim}_T_{args.T}"
            f"_fit_{args.fit_steps}_seed_{args.seed}.npz")
        np.savez(fname, losses=np.asarray(losses),
                 err_before=e0, err_after=e1, fit_time=el,
                 **{f"tuned_{k}": v for k, v in scalars(params2).items()})
        print("saved", fname)


if __name__ == "__main__":
    main()
