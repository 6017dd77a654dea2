"""Shared helpers of the port's parity tests (tests/test_torch_*.py): run
the same network through the JAX package and the port and bound the
difference.

Bounds: rate networks max-abs <= 1e-4 relative to max(|probe|, 1);
spiking networks within tests/test_backends.py's spike-flip bounds (median
< atol, q80 < 5 atol, peak < 0.25, under 10 % of steps above 5 atol, the
longest such run at most max(5, 3 % of steps)), atol = 1e-3.
"""

import jax
import numpy as np
import torch

from sspslam_tpu.nef import Simulator as JaxSimulator

from sspslam_tpu_torch.nef.builder import build as port_build
from sspslam_tpu_torch.nef.executor import make_step_fn, params_from_numpy

RATE_TOL = 1e-4
SPIKE_ATOL = 1e-3


def host_params(jax_params):
    """The JAX params tree with float32 NumPy leaves (bf16 leaves widen
    exactly; params_from_numpy casts them back)."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jax_params)


def to_tensors(tree):
    if isinstance(tree, dict):
        return {k: to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_tensors(v) for v in tree]
    return torch.as_tensor(np.array(tree))


def leaves(tree):
    """Leaves in jax.tree_util order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def assert_close(got, want, spiking=False, what="probe"):
    """``got`` vs ``want`` of shape (steps, ...): max-abs within RATE_TOL
    (relative to max(|want|, 1)), or the spike-flip bounds."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    per_t = np.max(np.abs(got - want).reshape(len(got), -1), axis=1)
    scale = max(float(np.max(np.abs(want))), 1.0)
    if not spiking:
        err = per_t.max() / scale
        assert err <= RATE_TOL, f"{what}: max-abs {err} > {RATE_TOL}"
        return
    atol = SPIKE_ATOL
    exc = per_t / scale > 5 * atol
    run, longest = 0, 0
    for e in exc:
        run = run + 1 if e else 0
        longest = max(longest, run)
    assert np.median(per_t) / scale < atol, (what, np.median(per_t))
    assert np.quantile(per_t, 0.8) / scale < 5 * atol, what
    assert per_t.max() / scale < 0.25, (what, per_t.max())
    assert np.mean(exc) < 0.10, (what, np.mean(exc))
    assert longest <= max(5, int(0.03 * len(exc))), (what, longest)


def step_both(jnet, pnet, n_steps, seed=0, jax_matmul=None,
              port_matmul=None):
    """Build ``jnet`` with the JAX package and ``pnet`` with the port, give
    the port the JAX parameters (params_from_numpy), and step both
    executors ``n_steps`` times on the JAX tabulation of the inputs.
    Returns ({probe index: (steps, ...)} for JAX, the same for the port,
    the final JAX state, the final port state, the port model)."""
    jsim = JaxSimulator(jnet, seed=seed, matmul_dtype=jax_matmul)
    model = port_build(pnet, dt=jsim.dt, seed=seed, device="cpu")
    params = params_from_numpy(model, host_params(jsim.params),
                               device="cpu", matmul_dtype=port_matmul)
    pstep = make_step_fn(model, matmul_dtype=port_matmul, device="cpu")
    jstep = jax.jit(jsim._step_fn)
    tables = [np.asarray(c) for c in jsim._tabulate_inputs(n_steps)]
    js = jsim.model.initial_state()
    ps = to_tensors(model.initial_state())
    jout, pout = {}, {}
    for i in range(n_steps):
        js, je = jstep(js, [c[i] for c in tables], jsim.params)
        ps, pe = pstep(ps, [torch.as_tensor(c[i]) for c in tables], params)
        for k in je:
            jout.setdefault(k, []).append(np.asarray(je[k]))
            pout.setdefault(k, []).append(pe[k].numpy())
    return ({k: np.stack(v) for k, v in jout.items()},
            {k: np.stack(v) for k, v in pout.items()}, js, ps, model)


def assert_runs_match(jnet, pnet, n_steps, seed=0, spiking=False, **kw):
    """step_both, then every dense probe and every state leaf within the
    bounds; returns step_both's result."""
    res = step_both(jnet, pnet, n_steps, seed=seed, **kw)
    jout, pout, js, ps, _ = res
    assert jout.keys() == pout.keys() and jout
    for k in jout:
        assert_close(pout[k], jout[k], spiking, what=f"probe {k}")
    for a, b in zip(leaves(ps), leaves(js)):
        b = np.asarray(b)
        if b.dtype.kind == "f" and b.size:
            scale = max(float(np.max(np.abs(b))), 1.0)
            err = float(np.max(np.abs(a.numpy() - b))) / scale
            assert spiking or err <= RATE_TOL, f"state leaf: {err}"
        else:
            np.testing.assert_array_equal(a.numpy(), b)
    return res
