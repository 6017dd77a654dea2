"""Gradient-based training through the simulator (the nengo_dl analog).

Port of :mod:`sspslam_tpu.train`.  The executor's step is a pure function
``step(state, xs, params)`` with every weight (scaled encoders, solved
decoders, connection transforms, learning rates, hoisted node tables) in
the ``params`` tree, so backprop through an episode is autograd through a
loop over the step:

* :func:`make_episode_fn` closes an episode into a differentiable
  ``episode(params, xs, state0)``, with sqrt-T rematerialisation: the time
  axis is split into segments, each run under
  ``torch.utils.checkpoint.checkpoint``, so the backward pass keeps only
  the segment-boundary states and recomputes the steps inside a segment
  (memory ``O(T/S · state + S · activations)`` instead of
  ``O(T · activations)``);
* :class:`~sspslam_tpu_torch.nef.SurrogateLIF` makes spiking dynamics
  differentiable (forward = ``LIF``, a fast-sigmoid surrogate through the
  spike threshold backward); rate-based training is
  ``Simulator(net, default_neuron_type=LIFRate())``;
* :func:`fit` runs a ``torch.optim`` loop over the subset of the parameter
  tree a path predicate selects, holding the rest frozen.

The episode steps the functional state eagerly under autograd; it does not
use the Simulator's state tensors, graphs or probe buffers, so training
leaves ``sim`` as it was.  With a ``mesh``, :func:`fit` is
data-parallel: each rank of the mesh's data axis runs its share of the
episodes, the parameters stay whole and bitwise equal on every rank, and
the gradients are summed by one all-reduce before the optimizer step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .ops.quantize import QTensor

__all__ = ["make_episode_fn", "make_batched_episode_fn", "episode_inputs",
           "batched_initial_state", "probe_index", "connection_param_path",
           "learning_rate_path", "partition_params", "merge_params", "fit"]


def probe_index(sim, probe) -> int:
    """Emit-dict key of ``probe`` in the episode outputs."""
    bp = next(p for p in sim.model.probes if p.obj is probe)
    return bp.index


def connection_param_path(sim, conn) -> str:
    """Params-tree path of a Connection's solved decoders ("conn/<i>/D"),
    for use as a :func:`partition_params` / :func:`fit` trainable
    predicate target.

    Raises for connections without decoders, for learned (PES / Voja)
    connections, and for connections whose decoders the step reads through
    a batched ``dstack`` group einsum instead of the individual leaf (the
    leaf still exists for weight probes, but training it would change
    nothing)."""
    from .nef.executor import _ea_batch_decode_groups, _elem_decode_groups
    bc = next(c for c in sim.model.connections if c.obj is conn)
    if bc.decoders is None:
        raise ValueError("connection has no decoders (direct/transform-only)")
    if bc.learned_slot is not None:
        # learned decoders live in the state, not the params tree: no
        # conn/<i>/D leaf exists, so fit() would train an empty subset
        raise ValueError(
            f"connection conn/{bc.index} is learned online (PES/Voja): its "
            "decoders are state, not a params leaf; tune the rule through "
            "the online dynamics instead via learning_rate_path(sim, conn)")
    for groups in (_elem_decode_groups(sim.model),
                   _ea_batch_decode_groups(sim.model)):
        for key, bcs in groups.items():
            if any(b is bc for b in bcs):
                raise ValueError(
                    f"connection's decoders are consumed via the batched "
                    f"group einsum dstack/{key} (rows shared with "
                    f"{len(bcs) - 1} other connection(s)); training the "
                    f"individual conn/{bc.index}/D leaf would not affect "
                    f"the step")
    return f"conn/{bc.index}/D"


def learning_rate_path(sim, conn) -> str:
    """Params-tree path of a learned Connection's PES / Voja learning rate
    ("hyper/lr/<slot>").  The rate is a 0-d tensor read inside the step's
    weight update, so selecting it in :func:`fit` descends the gradient
    THROUGH the online learning dynamics (meta-learning)."""
    bc = next(c for c in sim.model.connections if c.obj is conn)
    if bc.learned_slot is None:
        raise ValueError("connection has no PES/Voja learning rule")
    return f"hyper/lr/{bc.learned_slot}"


def episode_inputs(sim, n_steps: int) -> np.ndarray:
    """Packed ``(n_steps, sum input widths)`` host table of the network's
    tabulated input nodes, starting at the simulator's current step."""
    return sim._pack_cols(sim._tabulate_inputs(n_steps))


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-shaped nested dicts / lists; None and
    every non-container (a tensor, a QTensor, an array) is a leaf."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def _leaves_with_paths(tree, path=()):
    """(slash path, leaf) pairs in the JAX package's order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves_with_paths(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _state_on(tree, device):
    """A state tree (NumPy arrays or tensors) as tensors on ``device``."""
    return _tree_map(lambda x: (x if torch.is_tensor(x) else
                                torch.as_tensor(np.array(x))).to(device),
                     tree)


def _make_episode(sim, n_steps: int, segment_steps: Optional[int],
                  remat: bool, batched: bool):
    """Shared body of :func:`make_episode_fn` (``batched=False``) and
    :func:`make_batched_episode_fn` (``batched=True``): a loop over
    segments, each segment a loop over the step (under
    ``torch.func.vmap`` when batched) and, with ``remat``, one checkpoint."""
    step = sim._step_fn
    splits = sim.input_splits
    width = sum(n.size_out for n in sim.model.input_nodes)
    device = sim.device
    if segment_steps is None:
        segment_steps = min(n_steps, 100)
    seg = int(segment_steps)
    if n_steps % seg:
        raise ValueError(
            f"n_steps={n_steps} must be a multiple of segment_steps={seg} "
            "(the remat loop needs equal segments)")
    n_seg = n_steps // seg
    # the vmap is made inside each checkpointed segment, never around it
    body_step = (torch.func.vmap(step, in_dims=(0, 0, None)) if batched
                 else step)

    def seg_fn(state, xs_seg, params):
        # xs_seg: (seg, width), or time-major (seg, B, width)
        rows = []
        for i in range(seg):
            x = xs_seg[i]
            state, emits = body_step(state, [x[..., a:b] for a, b in splits],
                                     params)
            rows.append(emits)
        return state, {k: torch.stack([e[k] for e in rows])
                       for k in rows[0]}

    def episode(params, xs_packed, state0):
        xs = torch.as_tensor(xs_packed, dtype=torch.float32).to(device)
        if batched:
            # (B, T, w) -> time-major (T, B, w)
            xs = xs.movedim(0, 1)
        if xs.shape[0] != n_steps or xs.shape[-1] != width:
            raise ValueError(f"inputs of shape {tuple(xs.shape)}: expected "
                             f"{n_steps} steps of width {width}")
        state = _state_on(state0, device)
        chunks = []
        for s in range(n_seg):
            xs_seg = xs[s * seg:(s + 1) * seg]
            if remat:
                # the step draws no random numbers: no RNG state to keep
                state, emits = checkpoint(seg_fn, state, xs_seg, params,
                                          use_reentrant=False,
                                          preserve_rng_state=False)
            else:
                state, emits = seg_fn(state, xs_seg, params)
            chunks.append(emits)
        emits = {}
        for k in chunks[0]:
            e = torch.cat([c[k] for c in chunks])
            # time-major back to (B, n_steps, ...)
            emits[k] = e.movedim(0, 1) if batched else e
        return state, emits

    return episode


def make_episode_fn(sim, n_steps: int, segment_steps: Optional[int] = None,
                    remat: bool = True):
    """Build ``episode(params, xs_packed, state0) -> (final_state, emits)``.

    ``emits`` maps probe index (see :func:`probe_index`) to the
    ``(n_steps, ...)`` probe trace; both outputs are differentiable with
    respect to the tensors of ``params`` (and ``xs_packed``) that require
    grad.  ``state0`` is not baked in: pass ``sim.model.initial_state()``
    (host arrays; or a tree of tensors, e.g. a checkpointed state).  The
    episode runs on ``sim.device``.

    ``segment_steps`` sets the remat granularity: the backward pass keeps
    one state per segment and recomputes inside.  For a state of size C and
    per-step activations of size A, peak memory is ``(n_steps/S)·C + S·A``,
    least near ``S = sqrt(n_steps·C/A)``; the default is 100.  With
    ``remat=False`` the plain loop keeps every step's activations.
    """
    return _make_episode(sim, n_steps, segment_steps, remat, batched=False)


def batched_initial_state(sim, batch: int):
    """``sim.model.initial_state()`` broadcast to a leading episode axis
    (tensors on ``sim.device``): the ``state0`` of a
    :func:`make_batched_episode_fn` episode."""
    return _tree_map(
        lambda x: torch.as_tensor(np.array(x)).expand(
            (batch,) + np.shape(x)).clone().to(sim.device),
        sim.model.initial_state())


def make_batched_episode_fn(sim, n_steps: int,
                            segment_steps: Optional[int] = None,
                            remat: bool = True):
    """Batched (data-parallel) variant of :func:`make_episode_fn`.

    Returns ``episode(params, xs_packed, state0) -> (final_state, emits)``
    where ``xs_packed`` is ``(B, n_steps, width)`` (one packed input table
    per episode: :func:`episode_inputs` rows, stacked), ``state0`` has a
    leading episode axis on every leaf (:func:`batched_initial_state`), and
    ``emits`` maps probe index to ``(B, n_steps, ...)``.  Each step is the
    executor's step under ``torch.func.vmap`` over the episode axis, with
    the parameters shared (as ``parallel.trials`` runs it), the inputs
    time-major so each step reads one ``(B, width)`` row.
    """
    return _make_episode(sim, n_steps, segment_steps, remat, batched=True)


# ---------------------------------------------------------------------------
# Parameter partitioning: train a path-selected subset, freeze the rest
# ---------------------------------------------------------------------------

def partition_params(params, predicate: Callable[[str], bool]):
    """Split the params tree into ``(trainable, frozen)`` by a predicate on
    slash-joined leaf paths (e.g. ``"conn/3/D"``, ``"ens/0/bias"``,
    ``"hyper/lr/pes_0"``).  Both trees have the full structure with
    ``None`` at the complementary leaves; recombine with
    :func:`merge_params`."""
    def split(tree, path=()):
        if isinstance(tree, dict):
            parts = {k: split(v, path + (str(k),)) for k, v in tree.items()}
            return ({k: t for k, (t, _) in parts.items()},
                    {k: f for k, (_, f) in parts.items()})
        if isinstance(tree, (list, tuple)):
            parts = [split(v, path + (str(i),)) for i, v in enumerate(tree)]
            return [t for t, _ in parts], [f for _, f in parts]
        if predicate("/".join(path)):
            return tree, None
        return None, tree

    return split(params)


def merge_params(trainable, frozen):
    """Inverse of :func:`partition_params` (leaf-wise first non-None)."""
    return _tree_map(lambda t, f: f if t is None else t, trainable, frozen)


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------

def _gather_batch(x, group):
    """The whole batch of ``x`` (this rank's episodes along axis 0) from
    every rank of ``group``: the other ranks' parts as constants, this
    rank's own tensor in its place (so autograd reaches it)."""
    import torch.distributed as dist
    if not torch.is_tensor(x):
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    parts[dist.get_rank(group)] = x
    return torch.cat(parts)


def _device_of(tree):
    for _, leaf in _leaves_with_paths(tree):
        if torch.is_tensor(leaf):
            return leaf.device
    return torch.device("cpu")


def fit(episode, params, xs, state0,
        loss_fn: Callable[[Dict[int, torch.Tensor], dict], torch.Tensor],
        trainable: Callable[[str], bool],
        optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
        steps: int = 100,
        callback: Optional[Callable[[int, float], None]] = None,
        keep_best: bool = False, mesh=None,
        batch_axis: str = "data") -> Tuple[dict, list]:
    """Minimise ``loss_fn(emits, final_state)`` over the path-selected
    parameter subset (Adam, learning rate 1e-3, by default: optax's
    ``adam`` rule, β 0.9 / 0.999, ε 1e-8, bias-corrected).

    ``optimizer`` is a callable that takes the list of trainable tensors
    and returns a ``torch.optim.Optimizer``.  The trainable leaves become
    float32 copies that require grad, on the params' device; ``params``
    itself is not changed.  Returns ``(updated full params, per-step
    losses)``; each loss is the one at the parameters before that step's
    update.  ``keep_best`` returns the lowest-loss iterate, the final one
    (evaluated once more after the loop) included; if every loss was
    non-finite, the last iterate.

    ``mesh`` (:func:`parallel.sharding.make_mesh`) with a ``batch_axis``
    axis: data-parallel training of a :func:`make_batched_episode_fn`
    episode.  Every rank passes the same whole ``params``, ``xs`` (B, T,
    width) and ``state0``; rank c of the axis's n runs episodes
    [c B / n, (c + 1) B / n).  The emits and the final state are gathered
    (the other ranks' parts as constants), so every rank computes the
    loss of the whole batch and the gradient through its own episodes;
    one all-reduce sums the gradients, and a checksum all-reduce holds
    the parameters bitwise equal across ranks after every step.

    Learning-rate scale: Adam's per-coordinate step is about the learning
    rate itself, and NEF decoder weights are small (O(1e-3) for a
    population decoding an O(1) signal): 5e-3 overshoots decoders and
    diverges.  Start near 1e-4..1e-3 for decoder-scale leaves.
    """
    device = _device_of(params)
    train_p, frozen_p = partition_params(params, trainable)
    leaves = []

    def make_leaf(x):
        if x is None:
            return None
        if isinstance(x, QTensor):
            raise TypeError("cannot train a quantised (QTensor) leaf")
        t = (x.detach() if torch.is_tensor(x) else
             torch.as_tensor(np.asarray(x)))
        t = t.to(device=device, dtype=torch.float32, copy=True)
        t.requires_grad_(True)
        leaves.append(t)
        return t

    train_p = _tree_map(make_leaf, train_p)
    opt = (optimizer(leaves) if optimizer is not None
           else torch.optim.Adam(leaves, lr=1e-3))
    xs = torch.as_tensor(xs, dtype=torch.float32).to(device)
    state0 = _state_on(state0, device)
    group = None
    if mesh is not None:
        from .parallel.sharding import assert_same_on_ranks
        if batch_axis not in mesh.shape:
            raise ValueError(f"mesh has no '{batch_axis}' axis: {mesh}")
        group, nd = mesh.group(batch_axis), mesh.shape[batch_axis]
        if xs.shape[0] % nd:
            raise ValueError(f"fit: {xs.shape[0]} episodes over a data "
                             f"axis of {nd}")
        share = xs.shape[0] // nd
        lo = mesh.coord(batch_axis) * share
        xs = xs[lo:lo + share]
        state0 = _tree_map(lambda x: x[lo:lo + share], state0)
        assert_same_on_ranks(leaves, group, "fit: the trainable leaves")

    def loss_of():
        final_state, emits = episode(merge_params(train_p, frozen_p), xs,
                                     state0)
        if group is not None:
            emits = {k: _gather_batch(v, group) for k, v in emits.items()}
            final_state = _tree_map(lambda x: _gather_batch(x, group),
                                    final_state)
        return loss_fn(emits, final_state)

    losses = []
    best_vals, best_loss = None, float("inf")
    for i in range(steps):
        prev = [t.detach().clone() for t in leaves] if keep_best else None
        opt.zero_grad(set_to_none=True)
        loss = loss_of()
        loss.backward()
        if group is not None:
            import torch.distributed as dist
            for t in leaves:
                # a leaf no episode of this rank reaches has a zero
                # gradient here (every rank joins every all-reduce)
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
                dist.all_reduce(t.grad, group=group)
        opt.step()
        if group is not None:
            assert_same_on_ranks(leaves, group, f"fit step {i}: parameters")
        losses.append(float(loss.detach()))   # loss at prev (pre-update)
        if keep_best and losses[-1] < best_loss:
            best_loss, best_vals = losses[-1], prev
        if callback is not None:
            callback(i, losses[-1])
    if keep_best:
        # the final iterate was never evaluated in the loop
        with torch.no_grad():
            final_loss = float(loss_of())
        if final_loss < best_loss or best_vals is None:
            # (None: every evaluated loss was non-finite; keep the last
            # iterate rather than return a tree with holes)
            best_vals = [t.detach() for t in leaves]
        with torch.no_grad():
            for t, v in zip(leaves, best_vals):
                t.copy_(v)
    return merge_params(_tree_map(
        lambda t: None if t is None else t.detach(), train_p), frozen_p), \
        losses
