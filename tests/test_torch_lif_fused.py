"""Which path ``LIF.step`` takes: the hand-written kernel
(``csrc/lif_step.cu``, counter ``lif.fused``) or the ATen chain
(``neurons._lif_step_plain``, counter ``lif.plain``).

The kernel runs only on the card (``chip_smoke.py --lif`` holds it there to
the chain bitwise).  Here the card test (``lif_step._on_card``) is stood in
for and the launch (``lif_step._launch``) replaced by the chain on the
contiguous float32 tensors of one shape it is handed, so what decides the
path is what the arguments show: gradients, ``torch.func.vmap``,
``torch.export``; on the card the wrapper broadcasts and lays out what it
takes and refuses another dtype, a tensor ``dt`` and a card that is not
sm_90.  On the CPU every call takes the chain, bitwise, and never builds or
loads the kernel."""

import numpy as np
import pytest
import torch

from sspslam_tpu_torch.models import SLAMNetwork, get_slam_input_functions2
from sspslam_tpu_torch.nef import Connection, Network, Node, Probe, Simulator
from sspslam_tpu_torch.ops import lif_step, neurons
from sspslam_tpu_torch.sspspace import HexagonalSSPSpace, SPSpace
from sspslam_tpu_torch.utils import profiling

DT = 0.001


@pytest.fixture(autouse=True)
def fresh():
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()


def _inputs(shape, seed=0, dtype=torch.float32):
    """J below and above 1, neurons mid-refractory and free, voltages near
    the threshold and below ``min_voltage``."""
    g = torch.Generator().manual_seed(seed)
    J = torch.rand(shape, generator=g, dtype=dtype) * 5.0 - 1.5
    v = torch.rand(shape, generator=g, dtype=dtype) * 1.5 - 0.3
    r = (torch.rand(shape, generator=g, dtype=dtype) * 0.004 - 0.001)
    return {"voltage": v, "refractory": r}, J


def _stand_in_card(monkeypatch, launch=True):
    """Every tensor counts as on the card; with ``launch``, a launch runs
    the chain into the outputs it is handed."""
    def chain(lif, J, voltage, refractory, v_out, r_out, out, dt):
        xs = (J, voltage, refractory, v_out, r_out, out)
        assert all(x.is_contiguous() and x.dtype == torch.float32
                   and x.shape == J.shape for x in xs)
        new, o = neurons._lif_step_plain(
            lif, {"voltage": voltage, "refractory": refractory}, J, dt)
        v_out.copy_(new["voltage"])
        r_out.copy_(new["refractory"])
        out.copy_(o)
    monkeypatch.setattr(lif_step, "_on_card", lambda x: True)
    if launch:
        monkeypatch.setattr(lif_step, "_launch", chain)


@pytest.fixture
def card(monkeypatch):
    _stand_in_card(monkeypatch)


def _path(fn):
    """(fused, plain) calls of ``fn()`` while tracing."""
    profiling.reset()
    with profiling.tracing():
        fn()
    return profiling.counter("lif.fused"), profiling.counter("lif.plain")


@pytest.mark.parametrize("shape", [(970,), (3, 970), (49, 80), (78, 50)])
@pytest.mark.parametrize("neuron", [neurons.LIF(),
                                    neurons.LIF(tau_rc=0.05, tau_ref=0.001,
                                                amplitude=0.5,
                                                min_voltage=-0.2)],
                         ids=["default", "other-constants"])
def test_cpu_takes_the_plain_chain(neuron, shape):
    """Float32 and float64 on the CPU: every call counts ``lif.plain``
    and returns bitwise what ``_lif_step_plain`` does."""
    for dtype in (torch.float32, torch.float64):
        state, J = _inputs(shape, seed=len(shape), dtype=dtype)
        for _ in range(20):
            got = []
            assert _path(lambda: got.append(
                neuron.step(state, J, DT))) == (0, 1)
            new, out = got[0]
            want, want_out = neurons._lif_step_plain(neuron, state, J, DT)
            assert torch.equal(out, want_out) and out.dtype == dtype
            for k in ("voltage", "refractory"):
                assert torch.equal(new[k], want[k])
            state = new
        assert (out > 0).any() and (state["refractory"] > DT).any()


def test_counters_count_only_while_tracing(card):
    state, J = _inputs((40,))
    neurons.LIF().step(state, J, DT)
    assert profiling.counter("lif.fused") == 0
    assert _path(lambda: neurons.LIF().step(state, J, DT)) == (1, 0)


def test_requires_grad_keeps_the_chain(card):
    state, J = _inputs((4, 30))
    J.requires_grad_(True)
    assert _path(lambda: neurons.LIF().step(state, J, DT)) == (0, 1)


def _float64(state, J):
    return {k: v.double() for k, v in state.items()}, J.double(), DT


def _dt_tensor(state, J):
    return state, J, torch.tensor(DT)


def _two_devices(state, J):
    return {k: v.to("meta") for k, v in state.items()}, J, DT


@pytest.mark.parametrize("change", [_float64, _dt_tensor, _two_devices])
def test_card_refuses_what_the_kernel_cannot_take(card, change):
    """On the card the kernel raises where it cannot run, as ``vco_scan``
    does, rather than fall back to the chain."""
    state, J, dt = change(*_inputs((4, 30)))
    with pytest.raises(TypeError, match="lif_step"):
        neurons.LIF().step(state, J, dt)


def _strided(state, J):
    return {k: v.t() for k, v in state.items()}, J.t()


def _broadcast_current(state, J):
    return state, J[:1]


def _broadcast_state(state, J):
    return {k: v[1] for k, v in state.items()}, J


@pytest.mark.parametrize("change", [_strided, _broadcast_current,
                                    _broadcast_state])
def test_kernel_takes_any_layout(card, change):
    """Transposed and broadcast arguments reach the launch contiguous and
    of one shape; the results are the chain's, in its shape."""
    state, J = change(*_inputs((4, 30)))
    got = []
    assert _path(lambda: got.append(neurons.LIF().step(state, J, DT))) == (
        1, 0)
    (new, out), = got
    want, want_out = neurons._lif_step_plain(neurons.LIF(), state, J, DT)
    assert out.shape == want_out.shape and torch.equal(out, want_out)
    for k in ("voltage", "refractory"):
        assert new[k].shape == want[k].shape and torch.equal(new[k], want[k])


def test_card_that_is_not_sm90_raises(monkeypatch):
    _stand_in_card(monkeypatch, launch=False)
    monkeypatch.setattr(lif_step, "_sm90", {})
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "an sm_80")
    state, J = _inputs((4, 30))
    with pytest.raises(RuntimeError, match="sm_90a"):
        neurons.LIF().step(state, J, DT)
    assert lif_step._lib is None


def test_grad_disabled_takes_the_kernel(card):
    state, J = _inputs((4, 30))
    J.requires_grad_(True)
    with torch.no_grad():
        assert _path(lambda: neurons.LIF().step(state, J, DT)) == (1, 0)


def test_gradient_through_the_chain(card):
    state, J = _inputs((200,))
    J.requires_grad_(True)
    fused, plain = _path(lambda: neurons.LIF().step(state, J, DT)[0]
                         ["voltage"].sum().backward())
    assert (fused, plain) == (0, 1)
    assert J.grad is not None and torch.isfinite(J.grad).all()


def test_vmap_keeps_the_chain(card):
    state, J = _inputs((3, 50))
    lif = neurons.LIF()

    def one(v, r, j):
        new, out = lif.step({"voltage": v, "refractory": r}, j, DT)
        return new["voltage"], new["refractory"], out
    got = []
    assert _path(lambda: got.append(torch.func.vmap(one)(
        state["voltage"], state["refractory"], J))) == (0, 1)
    new, out = neurons._lif_step_plain(lif, state, J, DT)
    for a, b in zip(got[0], (new["voltage"], new["refractory"], out)):
        assert torch.equal(a, b)


def test_export_keeps_the_chain(card):
    lif = neurons.LIF()

    class Step(torch.nn.Module):
        def forward(self, v, r, j):
            new, out = lif.step({"voltage": v, "refractory": r}, j, DT)
            return new["voltage"], new["refractory"], out
    state, J = _inputs((2, 20))
    args = (state["voltage"], state["refractory"], J)
    programs = []
    assert _path(lambda: programs.append(
        torch.export.export(Step(), args))) == (0, 1)
    got = programs[0].module()(*args)
    new, out = neurons._lif_step_plain(lif, state, J, DT)
    for a, b in zip(got, (new["voltage"], new["refractory"], out)):
        assert torch.equal(a, b)


def test_quantized_lif_steps_through_lif_step(card):
    state, J = _inputs((5, 64))
    q = neurons.QuantizedLIF(levels=16)
    fused, plain = _path(lambda: q.step(state, J, DT))
    assert (fused, plain) == (1, 0)
    new, out = q.step(state, J, DT)
    want, want_out = neurons._lif_step_plain(q, state, J, DT)
    assert torch.equal(out, want_out)
    assert torch.equal(new["voltage"], torch.round(want["voltage"] * 16) / 16)


def test_surrogate_and_loihi_keep_their_own_steps(card):
    state, J = _inputs((64,))
    for neuron in (neurons.SurrogateLIF(), neurons.LoihiLIF()):
        assert _path(lambda: neuron.step(state, J, DT)) == (0, 0)


def _slam(seed=3, steps=40, d=25, lms=4):
    rng = np.random.default_rng(seed)
    path = np.cumsum(rng.normal(0, 0.002, (steps, 2)), axis=0)
    vels = np.diff(path, axis=0, prepend=path[:1]) / DT
    obj = rng.uniform(-0.5, 0.5, (lms, 2))
    space = HexagonalSSPSpace(2, ssp_dim=d, length_scale=0.6, seed=seed,
                              domain_bounds=np.tile([-1.0, 1.0], (2, 1)))
    lm = SPSpace(lms, d, seed=seed)
    vf, scale, seen, _, spf, _, vsf = get_slam_input_functions2(
        space, lm, vels, obj[None] - path[:, None], 0.5)
    with Network(seed=seed) as model:
        nodes = [Node(f) for f in (vsf, spf, seen, vf)]
        slam = SLAMNetwork(space, lm, 0.5, lms, 20, 30, 10,
                           vel_scaling_factor=scale, seed=seed,
                           cleanup_samples_per_dim=20)
        for node, post in zip(nodes, (slam.landmark_vec_ssp,
                                      slam.landmark_id_input,
                                      slam.no_landmark_in_view,
                                      slam.velocity_input)):
            Connection(node, post, synapse=None)
        probe = Probe(slam.pathintegrator.output, synapse=0.05)
    return model, probe


@pytest.fixture(scope="module")
def slam():
    return _slam()


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
def test_slam_step_calls_lif_step_once_a_group(slam, monkeypatch, on_card):
    """The SLAM step steps its four LIF ensemble groups (OVC; memory, error
    and recall; the VCO bank; the convolutions' products) through
    ``LIF.step`` once each; with the card stood in for, all four take the
    kernel and the rows are the chain's."""
    model, probe = slam
    steps = 10
    sim = Simulator(model, seed=3, device="cpu")
    sim.run_steps(steps)
    want = sim.data[probe].copy()
    if on_card:
        _stand_in_card(monkeypatch)
    sim = Simulator(model, seed=3, device="cpu")
    fused, plain = _path(lambda: sim.run_steps(steps))
    groups = [be for be in sim.model.ensembles
              if type(be.neuron_type) is neurons.LIF]
    assert len(groups) == 4
    assert (fused, plain) == ((4 * steps, 0) if on_card else (0, 4 * steps))
    np.testing.assert_array_equal(sim.data[probe], want)


def test_cpu_path_never_builds_the_kernel(slam, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the CUDA kernel")
    for name in ("build_lif_kernel", "_load", "lif_step", "_launch"):
        monkeypatch.setattr(lif_step, name, refuse)
    model, probe = slam
    sim = Simulator(model, seed=3, device="cpu")
    sim.run_steps(5)
    assert np.isfinite(sim.data[probe]).all()
    state, J = _inputs((2, 30))
    neurons.QuantizedLIF().step(state, J, DT)
    assert lif_step._lib is None
