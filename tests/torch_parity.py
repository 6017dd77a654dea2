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
from sspslam_tpu.ops.quantize import QTensor as JaxQTensor

from sspslam_tpu_torch.nef.builder import build as port_build
from sspslam_tpu_torch.nef.executor import make_step_fn, params_from_numpy
from sspslam_tpu_torch.ops.quantize import QTensor

RATE_TOL = 1e-4
SPIKE_ATOL = 1e-3


def host_params(jax_params):
    """The JAX params tree with float32 NumPy leaves (bf16 leaves widen
    exactly; params_from_numpy casts them back); a QTensor keeps its 1-byte
    payload (int8, or ml_dtypes' float8_e4m3fn) and float32 scales."""
    def host(x):
        if isinstance(x, JaxQTensor):
            return JaxQTensor(np.asarray(x.q), np.asarray(x.s, np.float32),
                              x.caxis)
        return np.asarray(x, np.float32)
    return jax.tree_util.tree_map(
        host, jax_params, is_leaf=lambda x: isinstance(x, JaxQTensor))


def with_port_hoisted(model, np_params):
    """``np_params`` (host_params of a JAX tree) with the hoisted tables
    laid out as the port's build of the same network lays them out.  The
    port hoists every table a node function reads; the JAX package keeps
    some in closures (the Newton and MLP clean-ups, PathIntegrationReencode's
    bank), so those come from the port's own build, and the JAX package's
    hoisted entries are matched to the port's by their table names (the
    entries are numbered in build order, which a port-only entry shifts)."""
    from sspslam_tpu_torch.nef.executor import build_params
    own = build_params(model, device="cpu")["hoisted"]
    given = np_params.get("hoisted", {})
    # entries with the same table names (two SLAMs in one network) pair up
    # in build order
    by_names = {}
    for k in sorted(given, key=lambda k: int(k[1:])):
        by_names.setdefault(tuple(sorted(given[k])), []).append(k)
    hoisted = {}
    for key in sorted(own, key=lambda k: int(k[1:])):
        tables = own[key]
        jkeys = by_names.get(tuple(sorted(tables)))
        hoisted[key] = (given[jkeys.pop(0)] if jkeys else
                        {n: t.float().numpy() for n, t in tables.items()})
    left = {k: v for k, v in by_names.items() if v}
    assert not left, f"JAX hoisted entries the port lacks: {left}"
    return dict(np_params, hoisted=hoisted)


# Runs a JAX package CLI script as ``python script`` does, recording every
# Simulator it builds, then saves each one's dense probe traces (with
# "all" second, its sparse snapshots too) to the npz named first: key
# "s<i>_p<probe index>" for the i-th Simulator built.
_RECORDED_JAX_CLI = """
import runpy, sys
import numpy as np
import sspslam_tpu.nef as nef
out, which, sys.argv = sys.argv[1], sys.argv[2], sys.argv[3:]
sims = []
class Recorded(nef.Simulator):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        sims.append(self)
nef.Simulator = Recorded
runpy.run_path(sys.argv[0], run_name="__main__")
np.savez(out, **{f"s{i}_p{bp.index}": np.asarray(s.data[bp.obj])
                 for i, s in enumerate(sims) if s.n_steps
                 for bp in s.model.probes if which == "all" or not bp.sparse})
"""


def start_jax_cli(script, args, traces=None, sparse=False):
    """Start the JAX package's ``experiments/<script>`` with ``args`` in a
    child on the CPU (one thread, float32 clean-up argmax); with
    ``traces`` (an npz path) the child records its Simulators' dense probe
    traces there (with ``sparse``, the sparse probes' snapshots too).
    Returns the Popen (text stdout / stderr pipes)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(repo),
               SSPSLAM_CLEANUP_F32="1", OMP_NUM_THREADS="1")
    path = str(repo / "experiments" / script)
    cmd = ([sys.executable, "-c", _RECORDED_JAX_CLI, str(traces),
            "all" if sparse else "dense", path]
           if traces is not None else [sys.executable, path])
    return subprocess.Popen(cmd + list(args), cwd=repo, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def jax_cli_module(name):
    """The JAX package's ``experiments/<name>.py`` imported in this process
    (it puts the repository on sys.path itself; so does this)."""
    import importlib
    import sys
    from pathlib import Path
    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    return importlib.import_module(f"experiments.{name}")


def finish(proc, timeout=600):
    """A child of ``start_jax_cli`` waited for: it must exit 0; returns
    its standard output."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def run_port_cli(module, argv):
    """``sspslam_tpu_torch.experiments.<module>.main(argv)`` in this
    process, its standard output captured; returns (main's value,
    stdout)."""
    import contextlib
    import importlib
    import io
    cli = importlib.import_module(f"sspslam_tpu_torch.experiments.{module}")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        value = cli.main(list(argv))
    return value, out.getvalue()


def last_json(stdout):
    """The last line of a CLI's output that is a JSON object."""
    import json
    return json.loads(next(line for line in reversed(stdout.splitlines())
                           if line.startswith("{")))


def key_tree(obj):
    """The nested key structure of a JSON value (lists by their items')."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [key_tree(v) for v in obj]
    return None


def to_tensors(tree):
    if isinstance(tree, dict):
        return {k: to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_tensors(v) for v in tree]
    return torch.as_tensor(np.array(tree))


def leaves(tree):
    """Leaves in jax.tree_util order (sorted dict keys; a QTensor's payload,
    then its scales)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if isinstance(tree, (QTensor, JaxQTensor)):
        return [tree.q, tree.s]
    return [tree]


def bits(t):
    """A tensor's bytes as uint8, for bitwise comparison of any dtype
    (torch.equal takes no float8 on the CPU)."""
    return t.contiguous().view(torch.uint8) if t.ndim else \
        t.reshape(1).view(torch.uint8)


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


def assert_params_equal(model, params, matmul_dtype=None):
    """The port's own ``build_params(model, matmul_dtype)`` equals
    ``params`` (the JAX package's, carried across) leaf for leaf, dtype and
    bits, with every quantised leaf at the same place and contraction
    axis."""
    from sspslam_tpu_torch.nef.executor import build_params
    own = build_params(model, matmul_dtype, device="cpu")
    assert _caxes(own) == _caxes(params)
    assert len(leaves(own)) == len(leaves(params)) > 0
    for a, b in zip(leaves(own), leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(bits(a), bits(b))


def _caxes(tree, path=()):
    """{path: caxis} of a tree's QTensor leaves (either package's)."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _caxes(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _caxes(x, path + (i,)).items()}
    if isinstance(tree, (QTensor, JaxQTensor)):
        return {path: tree.caxis}
    return {}


def step_both(jnet, pnet, n_steps, seed=0, jax_matmul=None,
              port_matmul=None, check_params=False):
    """Build ``jnet`` with the JAX package and ``pnet`` with the port, give
    the port the JAX parameters (params_from_numpy; with ``check_params``
    first hold them to the port's own build, bitwise), and step both
    executors ``n_steps`` times on the JAX tabulation of the inputs.
    Returns ({probe index: (steps, ...)} for JAX, the same for the port,
    the final JAX state, the final port state, the port model)."""
    jsim = JaxSimulator(jnet, seed=seed, matmul_dtype=jax_matmul)
    model = port_build(pnet, dt=jsim.dt, seed=seed, device="cpu")
    params = params_from_numpy(
        model, with_port_hoisted(model, host_params(jsim.params)),
        device="cpu", matmul_dtype=port_matmul)
    if check_params:
        assert_params_equal(model, params, port_matmul)
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


def spawn_ranks(fn, world, tmp_path, timeout=240, args=()):
    """``fn(rank, world, device, *args)`` on ``world`` gloo ranks on the
    CPU (``parallel.sharding.spawn``): a ``file://`` rendezvous in a fresh
    directory under ``tmp_path`` (xdist workers never share one), one
    torch and BLAS thread per rank, and every rank killed and
    TimeoutError raised past ``timeout`` seconds.  ``fn`` lives in a
    module the ranks import without JAX (tests/torch_mesh_ranks.py).
    Returns the ranks' results in rank order."""
    from sspslam_tpu_torch.parallel.sharding import spawn
    return spawn(fn, world, "cpu", args=tuple(args), timeout=timeout,
                 rendezvous_dir=str(tmp_path), threads=1)
