"""The port's 1-byte parameter storage (sspslam_tpu_torch.ops.quantize and
the executor's int8 / fp8 path) against the JAX package's.

Tolerances:
- ``quantize``: payload and scales bitwise, for int8 and fp8, on several
  shapes and both contraction axes, with values within one rounding step
  of +-127 and of +-448 after scaling; ``dequant`` and ``quant_error``
  bitwise / within 1e-7;
- the port's own QTensor algebra: tests/test_quantize.py::TestQTensor's
  bounds (the factorisation within 1e-5 of the amax-relative output, int8
  error <= 0.5/127, fp8 <= 2^-4, zero slices exact);
- ``build_params(model, "int8" | "fp8")``: the same quantised leaves at the
  same places with the same contraction axes as the JAX package's, every
  payload and scale bitwise (a recurrent connection stays unquantised);
  ``params_from_numpy`` carries the JAX trees across bitwise;
- a small SLAMNetwork through both executors on the same int8 weights, 300
  steps of LIF: tests/torch_parity.py's spike-flip bounds;
- an int8 checkpoint: bitwise.

The JAX side is built with SSPSLAM_HOIST_CLEANUP=1 and SSPSLAM_HOIST_GATE=1
so both parameter trees have the port's keys, and SSPSLAM_CLEANUP_F32=1 on
both sides where the networks are stepped.
"""

import numpy as np
import pytest
import torch
from torch_parity import (assert_params_equal, assert_runs_match, bits,
                          host_params, with_port_hoisted)

import sspslam_tpu as jsp
import sspslam_tpu.models as jmodels
import sspslam_tpu.nef as jnef
from sspslam_tpu.ops import quantize as jq

import sspslam_tpu_torch as psp
import sspslam_tpu_torch.models as pmodels
import sspslam_tpu_torch.nef as pnef
from sspslam_tpu_torch.nef.builder import build as port_build
from sspslam_tpu_torch.nef.executor import _recurrent, params_from_numpy
from sspslam_tpu_torch.ops import quantize as pq

PACKAGES = ((jsp, jmodels, jnef), (psp, pmodels, pnef))
BOUNDS = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
D, N_LM, VIEW_RAD, STEPS = 25, 3, 0.8, 300


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def hoisted(monkeypatch):
    """The JAX package's hoisted layout; the clean-up's argmax in float32
    on both sides (a bf16 tie may pick a neighbouring cell)."""
    for name in ("SSPSLAM_HOIST_CLEANUP", "SSPSLAM_HOIST_GATE",
                 "SSPSLAM_CLEANUP_F32"):
        monkeypatch.setenv(name, "1")


def _jax_bits(a):
    """The bytes of a JAX / NumPy array (any dtype, float8 included)."""
    return torch.from_numpy(np.array(a).view(
        np.uint8).reshape(-1))


def _edge_values(shape, caxis, kind, rng):
    """Random values whose scaled magnitudes include, in every slice, the
    amax and values within one rounding step of the top of the grid
    (+-127 for int8, +-448 for fp8) and on both sides of a half step."""
    x = rng.standard_normal(shape).astype(np.float32)
    top = 127.0 if kind == "int8" else 448.0
    step = 1.0 if kind == "int8" else 32.0   # e4m3's spacing below 448
    x = np.moveaxis(x, caxis, -1).copy()
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    n = x.shape[-1]
    for j, frac in enumerate((1.0, -1.0, (top - step / 2) / top,
                              -(top - step / 2 - 1e-3) / top,
                              (top - step) / top, (top - 1.5 * step) / top)):
        if j < n - 1:
            x[..., j] = (frac * amax[..., 0]).astype(np.float32)
    x[..., n - 1] = 0.0
    return np.moveaxis(x, -1, caxis)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("shape,caxis", [((40, 64), -1), ((3, 33, 17), -2),
                                         ((7, 5, 32), 0)])
def test_quantize_matches_jax_bitwise(kind, shape, caxis):
    """q and s bitwise (an all-zero slice included), dequant bitwise,
    quant_error within 1e-7."""
    x = _edge_values(shape, caxis, kind, np.random.default_rng(len(shape)))
    x[(0,) * (x.ndim - 1)] = 0.0   # one whole slice of zeros
    zero = [slice(None)] * x.ndim
    zero[caxis] = slice(None)
    for ax in range(x.ndim):
        if ax != caxis % x.ndim:
            zero[ax] = 0
    x[tuple(zero)] = 0.0
    jqt = jq.quantize(x, caxis, kind)
    pqt = pq.quantize(torch.from_numpy(x), caxis, kind)
    assert pqt.caxis == jqt.caxis == caxis % x.ndim
    want_dtype = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    assert pqt.q.dtype == want_dtype and pqt.s.dtype == torch.float32
    assert torch.equal(bits(pqt.q).reshape(-1), _jax_bits(jqt.q))
    assert torch.equal(bits(pqt.s).reshape(-1), _jax_bits(jqt.s))
    np.testing.assert_array_equal(pqt.dequant().numpy(),
                                  np.asarray(jqt.dequant()))
    assert abs(pq.quant_error(x, caxis, kind)
               - jq.quant_error(x, caxis, kind)) <= 1e-7


def test_qtensor_algebra_matches_the_jax_oracle():
    """tests/test_quantize.py::TestQTensor on the port's QTensor: the scale
    factors out of the contraction, the error bounds, exact zero slices,
    and the pytree (torch.utils._pytree, as vmap sees it) round trip."""
    rng = np.random.default_rng(42)
    D_ = torch.from_numpy(rng.standard_normal((200, 64)).astype(np.float32))
    act = torch.from_numpy((rng.standard_normal(200) * 50).astype(
        np.float32))
    qt = pq.quantize(D_, caxis=0, kind="int8")
    exact = act @ qt.dequant()
    fact = (act @ qt.q.to(torch.float32)) * qt.s
    assert float((exact - fact).abs().max()) <= 1e-5 * float(
        exact.abs().max())
    x = rng.standard_normal((50, 80)).astype(np.float32)
    assert pq.quant_error(x, caxis=1, kind="int8") <= 0.5 / 127 + 1e-6
    assert pq.quant_error(x, caxis=1, kind="fp8") <= 2.0 ** -4 + 1e-6
    z = np.zeros((4, 16), np.float32)
    z[0] = 1.0
    zq = pq.quantize(z, caxis=1)
    assert torch.isfinite(zq.s).all()
    assert np.array_equal(zq.dequant().numpy()[1:], z[1:])
    import torch.utils._pytree as pytree
    flat, spec = pytree.tree_flatten({"D": qt})
    assert len(flat) == 2
    back = pytree.tree_unflatten(flat, spec)["D"]
    assert back.caxis == qt.caxis and torch.equal(back.q, qt.q)
    # the Simulator's tree helpers carry it too (payload, then scales)
    from sspslam_tpu_torch.nef.simulator import _flatten, _to_device
    moved = _to_device({"D": qt, "b": [np.ones(2)]}, "cpu")
    assert isinstance(moved["D"], pq.QTensor) and moved["D"].caxis == 0
    q, s_, b = _flatten(moved)
    assert torch.equal(q, qt.q) and torch.equal(s_, qt.s) and b.shape == (2,)
    with pytest.raises(ValueError, match="kind"):
        pq.quantize(x, 1, "int4")


def _slam(sp, models, nef):
    """A small SLAMNetwork (its PI bank at 64 LIF per VCO so the VCO
    recurrences contract >= 32 neurons) fed by the single-nearest
    adapter; returns the network."""
    space = sp.HexagonalSSPSpace(2, ssp_dim=D, seed=0, length_scale=0.3,
                                 domain_bounds=BOUNDS)
    dt = 0.001
    ts = dt * np.arange(STEPS)
    path = 0.6 * np.stack([np.sin(2 * np.pi * ts / 0.6),
                           np.cos(2 * np.pi * ts / 0.6)], 1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = np.random.default_rng(0).uniform(-0.7, 0.7, (N_LM, 2))
    vec = landmarks[None] - path[:, None]
    lm_space = sp.SPSpace(N_LM, D, seed=0)
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        models.get_slam_input_functions(space, lm_space, vels, vec, VIEW_RAD)
    with nef.Network(seed=0) as net:
        slam = models.SLAMNetwork(
            space, lm_space, VIEW_RAD, N_LM, pi_n_neurons=64,
            mem_n_neurons=90, circonv_n_neurons=30, vel_scaling_factor=scale,
            cleanup_samples_per_dim=30, seed=0, update_thres=0.2)
        for f, dst in ((vel_f, slam.velocity_input),
                       (nef.clamp_table(space.encode(path[:1]).ravel(), 0.05),
                        slam.pathintegrator.input),
                       (sp_f, slam.landmark_id_input),
                       (vecssp_f, slam.landmark_vec_ssp),
                       (in_view_f, slam.no_landmark_in_view)):
            nef.Connection(nef.Node(f), dst, synapse=None)
        nef.Probe(slam.output, synapse=0.05)
        nef.Probe(slam.assomemory.recall, synapse=0.01)
    return net


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_build_params_quantises_the_jax_leaves(kind, hoisted):
    """The same leaves quantised, at the same contraction axes, with the
    same payloads and scales; a recurrent connection (the VCO feedback)
    whose contraction is long enough stays in bf16; params_from_numpy
    carries the JAX tree (fp8 through its bytes) so that the port's own
    build equals it."""
    jnet, pnet = _slam(*PACKAGES[0]), _slam(*PACKAGES[1])
    jsim = jnef.Simulator(jnet, seed=0, matmul_dtype=kind)
    model = port_build(pnet, seed=0, device="cpu")
    given = params_from_numpy(
        model, with_port_hoisted(model, host_params(jsim.params)),
        device="cpu", matmul_dtype=kind)
    assert_params_equal(model, given, kind)
    quantised = [k for k, v in given["conn"].items()
                 if any(isinstance(x, pq.QTensor) for x in v.values())]
    assert len(quantised) >= 10
    recurrent = [bc for bc in model.connections if _recurrent(bc)
                 and bc.decoders is not None and bc.learned_slot is None
                 and np.shape(bc.decoders)[-2] >= 32]
    assert recurrent
    for bc in recurrent:
        leaf = given["conn"][str(bc.index)]["D"]
        assert not isinstance(leaf, pq.QTensor)
        assert leaf.dtype == torch.bfloat16


def test_int8_slam_runs_match_jax(hoisted):
    """SLAMNetwork (LIF) with int8 storage through both executors on the
    JAX package's int8 weights, 300 steps: the PI output and the recall
    within the spike-flip bounds, the weights checked bitwise first."""
    jnet, pnet = _slam(*PACKAGES[0]), _slam(*PACKAGES[1])
    jout, pout, *_ = assert_runs_match(jnet, pnet, STEPS, seed=0,
                                       spiking=True, jax_matmul="int8",
                                       port_matmul="int8", check_params=True)
    assert len(jout) == 2 and np.abs(pout[0][-1]).max() > 0.05


def test_int8_checkpoint_round_trips(tmp_path):
    """A checkpoint written by an int8 Simulator loads into another int8
    Simulator of the same network; both continue bitwise alike."""
    def sim():
        with pnef.Network(seed=4) as net:
            inp = pnef.Node(lambda t: np.array([np.sin(5 * t), 0.3]))
            ens = pnef.Ensemble(64, 2, neuron_type=pnef.LIF(), seed=4)
            out = pnef.Node(size_in=2)
            pnef.Connection(inp, ens, synapse=None)
            c = pnef.Connection(ens, out, synapse=0.02,
                                learning_rule_type=pnef.PES(1e-3))
            pnef.Connection(out, c.learning_rule, synapse=0.01)
            pnef.Connection(inp, c.learning_rule, transform=-1,
                            synapse=0.01)
            fixed = pnef.Node(size_in=2)
            pnef.Connection(ens, fixed, synapse=0.02)
            p = [pnef.Probe(out), pnef.Probe(fixed)]
        return pnef.Simulator(net, seed=4, matmul_dtype="int8",
                              device="cpu"), p
    a, pa = sim()
    assert any(isinstance(x, pq.QTensor)
               for c in a.params["conn"].values() for x in c.values())
    a.run_steps(100)
    ck = str(tmp_path / "int8.npz")
    a.save_checkpoint(ck)
    a.run_steps(100)
    b, pb = sim()
    b.load_checkpoint(ck)
    b.run_steps(100)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(a.data[x][-100:], b.data[y][-100:])
