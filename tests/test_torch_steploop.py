"""The port's device step loop (``nef/steploop.py``) on the CPU: its
replay plan with the CUDA capture replaced by a stub that records the
graph lengths, and the rows its eager steps read and write."""

from collections import Counter

import pytest
import torch

from sspslam_tpu_torch.nef import steploop


def _stub_loop(monkeypatch, captured, replays, **kw):
    """A loop whose runs take the graphed path, each capture recorded in
    ``captured`` and each replay counted in ``replays`` by graph length."""
    class Graph:
        def __init__(self, steps):
            self.steps = steps

        def replay(self):
            replays[self.steps] += 1

    def capture(device, leaves, pos, advance, steps, same_stream=False):
        captured.append(steps)
        return Graph(steps)
    monkeypatch.setattr(steploop, "_capture", capture)
    monkeypatch.setattr(steploop.StepLoop, "graphed",
                        property(lambda self: True))
    state = {"x": torch.zeros(1)}
    return steploop.StepLoop("cpu", lambda s, x, p: (s, {}), state, None,
                             {}, **kw)


@pytest.mark.parametrize("runs, lengths, replays", [
    ([(25, None)], [10, 1], {10: 2, 1: 5}),
    ([(7, None)], [1], {1: 7}),
    ([(25, None), (7, None)], [10, 1], {10: 2, 1: 12}),
    ([(13, 13), (13, 13)], [13], {13: 2}),
])
def test_replay_plan(monkeypatch, runs, lengths, replays):
    """Segments of 25 and 7 steps at 10 steps a graph replay 10-step
    graphs, then one-step graphs for the rest, each captured once per
    loop; a run of one ``unit`` (a closed-loop tick) replays one graph."""
    captured, counts = [], Counter()
    loop = _stub_loop(monkeypatch, captured, counts, graph_steps=10)
    for steps, unit in runs:
        loop.run(steps, unit=unit)
    assert captured == lengths
    assert counts == replays
    loop.use_table(torch.zeros((4, 1)))   # another table: captured again
    steps, unit = runs[0]
    loop.run(steps, unit=unit)
    assert captured == lengths + lengths


@pytest.mark.parametrize("one_index", [False, True])
def test_eager_rows(one_index):
    """Each eager step reads the table row at the row index (clamped to
    the last row unless the loop has one index) and writes its probe row
    at the position index; the state leaves keep their addresses."""
    table = torch.arange(5, dtype=torch.float32)[:, None]
    state = {"n": torch.zeros(1)}

    def step(s, x, params):
        return {"n": s["n"] + params}, {"x": x.clone()}
    loop = steploop.StepLoop("cpu", step, state, 1.0, {"x": (1,)},
                             one_index=one_index)
    leaf = state["n"]
    loop.use_table(table)
    if one_index:
        loop.run(5)
        want = [0, 1, 2, 3, 4]
    else:
        loop.run(7, row=2)
        want = [2, 3, 4, 4, 4, 4, 4]
    assert loop.bufs["x"][:, 0].tolist() == want
    assert state["n"] is leaf and float(leaf) == len(want)


def test_users_free_without_the_cycle_collector():
    """A Simulator and its batched episodes are freed when their last
    reference goes (no reference cycle through the loop's step), so their
    CUDA graphs are never destroyed by the collector in the middle of
    another capture, which would invalidate it."""
    import gc
    import weakref

    import numpy as np

    import sspslam_tpu_torch.nef as nef
    from sspslam_tpu_torch.parallel import BatchedEpisodes
    with nef.Network(seed=0) as net:
        inp = nef.Node(lambda t: np.array([0.3]))
        ens = nef.Ensemble(20, 1)
        nef.Connection(inp, ens, synapse=None)
        nef.Probe(ens, synapse=0.01)
    enabled = gc.isenabled()
    gc.disable()
    try:
        sim = nef.Simulator(net, seed=0, device="cpu")
        sim.run_steps(5)
        runner = BatchedEpisodes(sim, [np.zeros((5, 2, 1), np.float32)])
        runner.run(5)
        refs = [weakref.ref(x) for x in (sim, sim.loop, runner, runner.loop)]
        del sim, runner
        assert [r() for r in refs] == [None] * 4
    finally:
        if enabled:
            gc.enable()
