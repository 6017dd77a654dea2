"""The Simulator's and the builder's spans and counters
(``utils.profiling``): a tiny SLAM network's ``run_steps`` on the CPU
records ``sim.run_steps`` around ``sim.stage``, ``sim.replay`` and
``sim.probes`` once a segment, counts its steps and segments, and records
nothing with tracing off."""

import numpy as np
import pytest
import torch

from sspslam_tpu_torch.models import SLAMNetwork, get_slam_input_functions2
from sspslam_tpu_torch.nef import Connection, Network, Node, Probe, Simulator
from sspslam_tpu_torch.sspspace import HexagonalSSPSpace, SPSpace
from sspslam_tpu_torch.utils import profiling

D, L, STEPS = 25, 4, 200


@pytest.fixture(autouse=True)
def fresh():
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()


def _slam(seed=3):
    rng = np.random.default_rng(seed)
    path = np.cumsum(rng.normal(0, 0.002, (STEPS, 2)), axis=0)
    vels = np.diff(path, axis=0, prepend=path[:1]) / 0.001
    obj = rng.uniform(-0.5, 0.5, (L, 2))
    space = HexagonalSSPSpace(2, ssp_dim=D, length_scale=0.6, seed=seed,
                              domain_bounds=np.tile([-1.0, 1.0], (2, 1)))
    lm = SPSpace(L, D, seed=seed)
    vf, scale, seen, _, spf, _, vsf = get_slam_input_functions2(
        space, lm, vels, obj[None] - path[:, None], 0.5)
    with Network(seed=seed) as model:
        nodes = [Node(f) for f in (vsf, spf, seen, vf)]
        slam = SLAMNetwork(space, lm, 0.5, L, 20, 30, 10,
                           vel_scaling_factor=scale, seed=seed,
                           cleanup_samples_per_dim=20)
        for node, post in zip(nodes, (slam.landmark_vec_ssp,
                                      slam.landmark_id_input,
                                      slam.no_landmark_in_view,
                                      slam.velocity_input)):
            Connection(node, post, synapse=None)
        Probe(slam.pathintegrator.output, synapse=0.05)
    return model


def test_run_steps_spans_and_counters():
    model = _slam()
    with profiling.tracing():
        sim = Simulator(model, seed=3, device="cpu")
        sim.run_steps(30, segment_steps=10)
    recs = profiling.spans()
    names = [s.name for s in recs]
    assert names.count("build.ensembles") == 1
    assert names.count("build.solve") == profiling.counter("build.solves")
    assert profiling.counter("build.solves") > 0
    runs = [i for i, s in enumerate(recs) if s.name == "sim.run_steps"]
    assert len(runs) == 1
    kids = [s.name for s in recs if s.parent == runs[0]]
    for name in ("sim.stage", "sim.replay", "sim.probes"):
        assert kids.count(name) == 3, (name, kids)
    # the CPU steps eagerly: no graph to capture, no device to wait on
    assert "sim.capture" not in names and "sim.wait" not in names
    run = recs[runs[0]]
    for s in recs:
        if s.parent == runs[0]:
            assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns
    assert profiling.counter("sim.steps") == 30
    assert profiling.counter("sim.replays") == 3
    assert profiling.counter("sim.captures") == 0


def test_nothing_recorded_with_tracing_off():
    sim = Simulator(_slam(), seed=3, device="cpu")
    sim.run_steps(20, segment_steps=10)
    assert profiling.spans() == []
    for name in ("sim.steps", "sim.replays", "sim.captures",
                 "build.solves"):
        assert profiling.counter(name) == 0


def test_spans_leave_the_run_unchanged():
    a = Simulator(_slam(), seed=3, device="cpu")
    a.run_steps(20, segment_steps=10)
    b = Simulator(_slam(), seed=3, device="cpu")
    with profiling.tracing():
        b.run_steps(20, segment_steps=10)
    pa, pb = a.model.probes[0].obj, b.model.probes[0].obj
    assert np.array_equal(a.data[pa], b.data[pb])
