"""Multi-device execution on ``torch.distributed``: the mesh, the
launcher, and which axis of each state and parameter leaf a rank holds.

Port of :mod:`sspslam_tpu.parallel.sharding`.  The JAX package annotates
its carry with ``NamedSharding`` and lets GSPMD partition the step.  Here
the step is SPMD by hand, one process per device: NCCL on
``cuda:{rank}``, gloo on the CPU.  A :class:`Mesh` stands in for
``jax.sharding.Mesh``: the axis names and sizes, this rank's coordinates
and one process group per axis.  The collectives are NCCL's (gloo's on
the CPU), issued by the sharded step (:mod:`..nef.executor`) outside the
hand-written kernel.

:func:`state_shardings` and :func:`params_shardings` follow the JAX
package's rules leaf for leaf, but return the axis a leaf is split on
(or ``None``, whole on every rank) instead of a ``NamedSharding``; a
quantised leaf gets a :class:`QTensor` of its payload's and its scale's
axes.  The sharded Simulator lays its tensors out as the step reads them
(:func:`step_layout`), which is these rules except where the step needs a
leaf whole; :func:`layout_differences` lists those leaves.
"""

from __future__ import annotations

import itertools
import os
import pickle
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..nef.builder import Model
from ..nef.steploop import flatten
from ..nef.executor import (_axes_like, _ea_batch_decode_groups,
                             _elem_decode_groups, _maybe_q, _spec_for,
                             group_axis, step_layout)
from ..ops.quantize import QTensor

__all__ = ["Mesh", "make_mesh", "init_rank", "spawn", "state_shardings",
           "params_shardings", "shard_tree", "gather_tree", "shard_state",
           "gather_state", "broadcast_tree", "tree_checksum",
           "assert_same_on_ranks", "layout_differences", "step_layout",
           "shard_params"]


# ---------------------------------------------------------------------------
# The mesh and the launcher
# ---------------------------------------------------------------------------

class Mesh:
    """One rank's view of a device mesh over an initialised process group.

    ``shape`` maps each axis name to its size (as ``jax.sharding.Mesh``);
    ranks are laid out row-major over the axes, so on a ("data", "model")
    mesh of (2, 2) rank 1 is data 0, model 1.  ``group(axis)`` is the
    process group of the ranks that differ from this one only along
    ``axis``; ``coord(axis)`` is this rank's place on it."""

    def __init__(self, axis_names, sizes, groups, device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = int(np.prod(sizes))
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self._groups = groups
        self._coords = dict(zip(self.axis_names,
                                np.unravel_index(self.rank, tuple(sizes))))

    def group(self, axis: str):
        return self._groups[axis]

    def coord(self, axis: str) -> int:
        return int(self._coords[axis])

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")


def make_mesh(n_devices: Optional[int] = None, axis_names=("model",),
              shape=None, device=None) -> Mesh:
    """The mesh of this process group: default one "model" axis over all
    ranks.  Every rank must call it with the same arguments (each axis's
    process groups are made by all ranks together).  ``n_devices`` must
    be the world size: a mesh never runs on fewer ranks than asked for.
    ``device`` defaults to the device :func:`init_rank` chose."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks "
                           "with parallel.sharding.spawn or init_rank")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_mesh: a mesh of {n_devices} devices over a "
                         f"world of {world} ranks")
    sizes = tuple(shape) if shape is not None else (n_devices,)
    if len(sizes) != len(axis_names) or int(np.prod(sizes)) != n_devices:
        raise ValueError(f"make_mesh: shape {sizes} does not lay "
                         f"{n_devices} devices over axes {axis_names}")
    ranks = np.arange(world).reshape(sizes)
    groups = {}
    for a, name in enumerate(axis_names):
        if sizes[a] == world:
            groups[name] = dist.group.WORLD
            continue
        # every rank makes every group of this axis, in the same order
        others = [range(s) for i, s in enumerate(sizes) if i != a]
        for fixed in itertools.product(*others):
            idx = list(fixed)
            idx.insert(a, slice(None))
            members = [int(r) for r in ranks[tuple(idx)]]
            g = dist.new_group(members)
            if dist.get_rank() in members:
                groups[name] = g
    if device is None:
        device = _RANK_DEVICE.get("device", "cpu")
    return Mesh(axis_names, sizes, groups, device)


_RANK_DEVICE = {}


def init_rank(rank: int, world: int, init_method: str,
              device="cuda") -> torch.device:
    """Join the process group as ``rank`` of ``world``: NCCL on
    ``cuda:{rank}`` (one process per card; more ranks than cards raise),
    gloo on the CPU.  Returns this rank's device."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_rank: device='cuda' but no CUDA device "
                               "is available")
        if world > torch.cuda.device_count():
            raise RuntimeError(f"init_rank: {world} CUDA ranks but "
                               f"{torch.cuda.device_count()} cards")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method,
                                world_size=world, rank=rank,
                                device_id=device)
    elif device.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank)
    else:
        raise ValueError(f"init_rank: no backend for {device}")
    _RANK_DEVICE["device"] = device
    return device


def _rank_main(rank, fn, world, init_method, device, args, out_dir,
               threads):
    if threads:
        torch.set_num_threads(threads)
        try:
            from threadpoolctl import threadpool_limits
            threadpool_limits(threads)
        except ImportError:
            pass
    dev = init_rank(rank, world, init_method, device)
    try:
        result = fn(rank, world, dev, *args)
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, device="cuda", args=(), *,
          timeout: Optional[float] = None, rendezvous_dir=None,
          threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` new
    processes joined into one process group (:func:`init_rank`), with a
    ``file://`` rendezvous in a fresh directory (under ``rendezvous_dir``
    if given; no TCP port is taken).  Returns the ranks' return values
    (pickled through that directory), in rank order.

    More CUDA ranks than cards raise here, before anything starts.
    ``timeout`` (seconds): past it every rank is killed and TimeoutError
    raised; a rank that fails fails the call.  ``threads``: torch's and
    the BLAS libraries' threads in each rank.  ``fn`` must be picklable
    (a module-level function)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spawn: device='cuda' but no CUDA device is "
                               "available")
        if world_size > torch.cuda.device_count():
            raise RuntimeError(f"spawn: {world_size} CUDA ranks but "
                               f"{torch.cuda.device_count()} cards")
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="sspslam_ranks_", dir=rendezvous_dir)
    try:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, init_method, str(dev), args,
                              tmp, threads),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = None if timeout is None else time.time() + timeout
        while True:
            left = None if deadline is None else deadline - time.time()
            if left is not None and left <= 0:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"spawn: {world_size} ranks still running "
                                   f"after {timeout} s; killed")
            if ctx.join(timeout=None if left is None else min(left, 1.0)):
                break
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The JAX package's rules: which axis of each leaf is split
# ---------------------------------------------------------------------------

def _size(mesh, axis) -> int:
    """The size of ``axis`` of a Mesh (or of a plain int, for the rules
    alone)."""
    return int(mesh) if isinstance(mesh, (int, np.integer)) \
        else int(mesh.shape[axis])


def _shard_leading(n: int, ndim: int, size0: int, min_size: int = 2,
                   size1: int = 0) -> Optional[int]:
    """The leading axis when it divides ``n``, else axis 1 (the neuron
    axis of a small-k fused group), else whole."""
    if size0 >= max(n, min_size) and size0 % n == 0:
        return 0
    if ndim >= 2 and size1 >= max(n, min_size) and size1 % n == 0:
        return 1
    return None


def state_shardings(model: Model, mesh, axis: str = "model"):
    """The split axis of every leaf of ``model.initial_state()``: batched
    groups over their element axis, large single ensembles over neurons,
    learned weights over their leading axis, small filters whole."""
    n = _size(mesh, axis)
    neurons = []
    for be in model.ensembles:
        shape = (be.k, be.n) if be.batched else (be.n,)
        proto = be.neuron_type.init_state(shape)
        neurons.append({
            key: _shard_leading(n, val.ndim, val.shape[0] if val.ndim else 1,
                                size1=val.shape[1] if val.ndim >= 2 else 0)
            for key, val in proto.items()})
    filters = []
    for shape, _a, _b in model.filter_specs:
        if len(shape) >= 2:
            filters.append(_shard_leading(n, len(shape), shape[0],
                                          size1=shape[1]))
        elif len(shape) == 1 and shape[0] >= 4 * n:
            filters.append(_shard_leading(n, 1, shape[0]))
        else:
            filters.append(None)
    learned = {key: _shard_leading(n, np.ndim(val), np.shape(val)[0])
               for key, val in model.learned_init.items()}
    return {"step": None, "neurons": neurons, "filters": filters,
            "learned": learned,
            "nodes": {k: None for k in model.node_state_init}}


def _is_batched(obj) -> bool:
    return bool(getattr(obj, "batched", False))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    if isinstance(tree, QTensor):
        return QTensor(fn(tree.q), fn(tree.s), tree.caxis)
    return fn(tree)


def params_shardings(params, mesh, axis: str = "model", model=None):
    """The split axis of every parameter leaf.  Without ``model``: whole,
    except 2-D hoisted tables (the clean-up's sample bank) over rows.
    With ``model``: encoders, gains, biases, solved decoders and batched
    decode stacks along the axis their ensemble's state is split on."""
    n = _size(mesh, axis)
    sh = _axes_like(params)
    for key, tables in params.get("hoisted", {}).items():
        for k2, v in tables.items():
            if len(v.shape) == 2 and v.shape[0] >= n and v.shape[0] % n == 0:
                sh["hoisted"][key][k2] = 0
    if model is None:
        return sh

    gaxis = {be.index: group_axis(n, be) for be in model.ensembles}
    for i, be in enumerate(model.ensembles):
        ga = gaxis[be.index]
        ep = params["ens"][i]
        sh["ens"][i]["scaled_encoders"] = _maybe_q(n, ep["scaled_encoders"],
                                                   ga)
        for k2 in ("bias", "gain"):
            sh["ens"][i][k2] = _spec_for(n, tuple(ep[k2].shape), ga)
    for bc in model.connections:
        entry = params["conn"].get(str(bc.index), {})
        if "D" in entry and getattr(bc.pre, "index", None) is not None:
            ga = gaxis.get(bc.pre.index)
            d_param = entry["D"]
            if bc.pre_kind == "ea_batch" and d_param.ndim == 3:
                sh["conn"][str(bc.index)]["D"] = _maybe_q(n, d_param, ga)
            elif d_param.ndim == 2 and not _is_batched(bc.pre):
                sh["conn"][str(bc.index)]["D"] = _maybe_q(
                    n, d_param, 0 if ga == 0 else None)
        if "W" in entry and bc.full_weights \
                and getattr(bc.pre, "index", None) is not None:
            w = entry["W"]
            if w.ndim == 3:
                sh["conn"][str(bc.index)]["W"] = _maybe_q(
                    n, w, gaxis.get(bc.pre.index))
    for key, bcs in _elem_decode_groups(model).items():
        ga = gaxis.get(bcs[0].pre.index)
        sh["dstack"][key] = _maybe_q(n, params["dstack"][key],
                                     1 if ga == 1 else None)
    for key, bcs in _ea_batch_decode_groups(model).items():
        ga = gaxis.get(bcs[0].pre.index)
        sh["dstack"][key] = _maybe_q(n, params["dstack"][key], ga)
    for bp in model.probes:
        entry = params["probe"].get(str(bp.index), {})
        if "D" in entry and getattr(bp.target, "index", None) is not None:
            ga = gaxis.get(bp.target.index)
            d_param = entry["D"]
            if d_param.ndim == 2 and not _is_batched(bp.target) and ga == 0:
                sh["probe"][str(bp.index)]["D"] = _maybe_q(n, d_param, 0)
    return sh


def layout_differences(model: Model, params, mesh, axis: str = "model"):
    """The leaves whose split in :func:`step_layout` differs from the
    JAX package's rules: [(path, JAX's axis, the step's axis)]."""
    n = _size(mesh, axis)
    s_axes, p_axes = step_layout(model, params, n)
    out = []
    for what, mine, theirs in (
            ("state", s_axes, state_shardings(model, n)),
            ("params", p_axes, params_shardings(params, n, model=model))):
        for path, a, b in zip(_paths(theirs, (what,)), flatten(theirs),
                              flatten(mine)):
            if a != b:
                out.append(("/".join(map(str, path)), a, b))
    return out


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, path + (i,))]
    if isinstance(tree, QTensor):
        return [path + ("q",), path + ("s",)]
    return [path]


# ---------------------------------------------------------------------------
# Slicing and reassembly
# ---------------------------------------------------------------------------

def _zip_map(tree, axes, fn):
    if isinstance(tree, dict):
        return {k: _zip_map(v, axes[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(v, a, fn) for v, a in zip(tree, axes)]
    if isinstance(tree, QTensor):
        return QTensor(fn(tree.q, axes.q), fn(tree.s, axes.s), tree.caxis)
    return fn(tree, axes)


def _slice(x, ax, rank, n):
    if ax is None or not torch.is_tensor(x):
        return x
    size = x.shape[ax] // n
    return x.narrow(ax, rank * size, size).contiguous()


def shard_tree(tree, axes, rank: int, n: int):
    """Rank ``rank``'s slices (of ``n``) of a whole tree of tensors along
    ``axes`` (a tree of split axes; None leaves stay whole)."""
    return _zip_map(tree, axes, lambda x, ax: _slice(x, ax, rank, n))


def gather_tree(tree, axes, mesh: Mesh, axis: str = "model"):
    """The whole tree from every rank's slices (``all_gather`` along each
    split leaf's axis); whole leaves are returned as they are."""
    group = mesh.group(axis)
    n = mesh.shape[axis]

    def gather(x, ax):
        if ax is None or not torch.is_tensor(x):
            return x
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=ax)
    return _zip_map(tree, axes, gather)


def shard_state(model: Model, state, mesh: Mesh, axis: str = "model",
                params=None):
    """This rank's slices of a whole state tree, as the sharded step
    reads them (:func:`step_layout`)."""
    axes = step_layout(model, params, mesh.shape[axis])[0]
    return shard_tree(state, axes, mesh.coord(axis), mesh.shape[axis])


def shard_params(model: Model, params, mesh: Mesh, axis: str = "model"):
    """This rank's slices of a whole parameter tree, as the sharded step
    reads them (:func:`step_layout`)."""
    axes = step_layout(model, params, mesh.shape[axis])[1]
    return shard_tree(params, axes, mesh.coord(axis), mesh.shape[axis])


def gather_state(model: Model, state, mesh: Mesh, axis: str = "model",
                 params=None):
    """The whole state tree from the ranks' slices."""
    axes = step_layout(model, params, mesh.shape[axis])[0]
    return gather_tree(state, axes, mesh, axis)


def broadcast_tree(tree, src: int = 0):
    """``tree`` with every tensor leaf made rank ``src``'s, byte for byte
    (over the default process group): contiguous leaves are overwritten
    in place, the others replaced by contiguous copies."""
    def bcast(x):
        if not torch.is_tensor(x) or not x.numel():
            return x
        x = x.contiguous()
        dist.broadcast(x.reshape(-1).view(torch.uint8), src)
        return x
    return _map(tree, bcast)


def tree_checksum(tree) -> torch.Tensor:
    """One int64 per leaf: the sum of the leaf's bytes, each weighted by
    its position modulo 251 plus one (a permuted or changed byte moves
    it)."""
    out = []
    for x in flatten(tree):
        if not torch.is_tensor(x):
            x = torch.as_tensor(np.asarray(x))
        b = x.detach().contiguous().reshape(-1).view(torch.uint8).to(
            torch.int64)
        w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) \
            % 251 + 1
        out.append((b * w).sum())
    return torch.stack(out) if out else torch.zeros(0, dtype=torch.int64)


def assert_same_on_ranks(tree, group=None, what="parameters") -> None:
    """Raise unless every rank of ``group`` holds bitwise the same
    ``tree`` (a checksum per leaf, its MAX and MIN all-reduced)."""
    cs = tree_checksum(tree).to(_RANK_DEVICE.get("device", "cpu"))
    hi, lo = cs.clone(), cs.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    bad = torch.nonzero(hi != lo).reshape(-1).tolist()
    if bad:
        raise RuntimeError(f"{what} differ across ranks at leaves {bad}")
