"""The port's plotting layer on the CPU against the JAX package's: the
spike helpers, the figure utilities, the network diagram, the three
simulating demos (``run_pathint_gif``, ``run_slam_map_gif``,
``slam_map_new``) and ``plot_trials_2d``.

The JAX demos run as children (``torch_parity.start_jax_cli``:
JAX_PLATFORMS=cpu, one thread), all started before the first test and
recording their Simulators' probe traces; the port's demos run in this
process at the same flags (tests/test_experiments.py's), through their
``build`` / ``simulate`` / ``render`` split.  Held:
- the spike helpers and the palette equal, the styles the same rcParams;
- the network diagram's text equal once node ids are renamed in order of
  first appearance (ids are ``id()`` of objects);
- every probe of each demo within the spike-flip bounds of
  tests/torch_parity.py (the raster of LIF spikes: at most 1 % of its
  entries differ); ``run_slam_map_gif``'s SLAM output over its frames in
  the first 300 steps (a SLAM trace leaves the other package's by spike
  flips after that, as in tests/test_torch_loop_closure_clis.py), and the
  learned weights and encoders every frame samples, within the same
  bounds; every GIF / PNG written;
- ``slam_map_new`` prints lines with the same keys, and the same numbers
  (at T = 4 s its WhiteSignal of high 0.05 Hz has no component, so the
  path stands still and its velocity is NaN in both packages: the
  reference's own quirk, as ``run_pathint``'s below 10 s); its probes
  within the spike-flip bounds, but for the inverse memory's final Voja
  encoders: its gate adds the in-view input (10 out of view) to the
  learning signal, so it learns at 11x its rate from a decoded zero key
  and single spike flips move whole rows; held within 5 % relative
  Frobenius norm, while in both packages they move by more than 20 %
  from their initial values over the 4 s;
- ``plot_trials_2d``'s bands of the port's ``run_pathint --save`` files
  equal JAX's ``band`` of the same files.
``run_slam --plot`` and ``run_slamview --plot`` are held in
tests/test_torch_slam.py and tests/test_torch_slam_family.py.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch_parity import (assert_close, finish, jax_cli_module,
                          run_port_cli, start_jax_cli)

import sspslam_tpu.models as jmodels
import sspslam_tpu.nef as jnef
import sspslam_tpu.utils as jutils
from sspslam_tpu import HexagonalSSPSpace as JaxHexagonalSSPSpace
from sspslam_tpu.utils import figure_utils as jfig
from sspslam_tpu.utils import spikes as jspikes

import sspslam_tpu_torch.models as pmodels
import sspslam_tpu_torch.nef as pnef
import sspslam_tpu_torch.utils as putils
from sspslam_tpu_torch import HexagonalSSPSpace
from sspslam_tpu_torch.experiments import run_pathint_gif as ppg
from sspslam_tpu_torch.experiments import run_slam_map_gif as pmg
from sspslam_tpu_torch.experiments import slam_map_new as psm
from sspslam_tpu_torch.utils import figure_utils as pfig
from sspslam_tpu_torch.utils import spikes as pspikes

RASTER_FLIPS = 0.01
PI_GIF = ["--T", "1", "--limit", "2.0", "--pi-n-neurons", "60",
          "--ssp-dim", "19", "--n-frames", "5", "--n-grid", "15",
          "--backend", "cpu"]
# tests/test_experiments.py's flags but 40 frames (one every 50 steps),
# so six frames fall in the first 300 steps
MAP_GIF = ["--T", "2", "--limit", "1.0", "--pi-n-neurons", "60",
           "--mem-n-neurons", "80", "--circonv-n-neurons", "16",
           "--ssp-dim", "19", "--n-landmarks", "3", "--n-frames", "40",
           "--n-grid", "12", "--backend", "cpu"]
EARLY_FRAMES = 6
INVERSE_ENCODERS_TOL = 0.05
INVERSE_MOVED = 0.2
MAP_NEW = ["--T", "4", "--pi-n-neurons", "60", "--circonv-n-neurons", "16",
           "--n-scales", "3", "--n-rotates", "3", "--backend", "cpu"]


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    # the clean-up's argmax in float32, as in the JAX children
    monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
    # the port's small ops run fastest on one thread, beside the JAX children
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_demos(tmp_path_factory):
    """The three JAX demos, started together before the first test: {name:
    (child, its traces npz, its output directory)}."""
    children = {}
    for name, script, flags, out in (
            ("pi_gif", "run_pathint_gif.py", PI_GIF, ("--out", "pi.gif")),
            ("map_gif", "run_slam_map_gif.py", MAP_GIF,
             ("--out", "map.gif")),
            ("map_new", "slam_map_new.py", MAP_NEW, ("--save-dir", "."))):
        d = tmp_path_factory.mktemp(f"jax_{name}")
        out = (out[0], str(d / out[1]))
        traces = d / "traces.npz"
        children[name] = (start_jax_cli(script, [*flags, *out],
                                        traces=traces, sparse=True),
                          traces, d)
    yield children
    for proc, _, _ in children.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _port_demo(module, flags):
    """The port's demo in this process: (args, built, result, stdout)."""
    args = module.parse_args(flags)
    built = module.build(args)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = module.simulate(args, built)
    return args, built, res, out.getvalue()


def _probe_index(sim, probe):
    return next(bp.index for bp in sim.model.probes if bp.obj is probe)


# -- spike helpers and figure utilities -------------------------------------
def _raster():
    rng = np.random.default_rng(0)
    return 1000.0 * (rng.random((200, 50)) < 0.05), 0.005 * np.arange(1, 201)


def test_spike_helpers_equal_jax():
    spikes, t = _raster()
    for fn, kw in (("cluster", {"filter_width": 0.02}),
                   ("sample_by_variance", {"num": 20, "filter_width": 0.02}),
                   ("merge", {"num": 7})):
        got = getattr(pspikes, fn)(t, spikes, **kw)
        want = getattr(jspikes, fn)(t, spikes, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=fn)


def test_plot_spikes_draws_what_jax_draws():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    spikes, t = _raster()
    offsets = []
    for mod in (pspikes, jspikes):
        fig, ax = plt.subplots()
        assert mod.plot_spikes(t, spikes, ax=ax) is ax
        offsets.append((ax.collections[0].get_offsets().data,
                        ax.get_xlim(), ax.get_ylim()))
        plt.close(fig)
    np.testing.assert_array_equal(offsets[0][0], offsets[1][0])
    assert offsets[0][1:] == offsets[1][1:]


def test_palette_and_styles_equal_jax():
    import matplotlib as mpl
    for name in ("blues", "greens", "reds", "oranges", "purples", "yellows",
                 "browns", "greys", "palette"):
        assert getattr(pfig, name) == getattr(jfig, name), name
    styles = []
    for mod in (pfig, jfig):
        with mpl.rc_context():
            mpl.rcdefaults()
            usetex = mod.use_publication_style(usetex=False)
            styles.append((usetex, dict(mpl.rcParams)))
    assert styles[0] == styles[1]


def test_circles_and_save(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    paths = []
    for mod in (pfig, jfig):
        fig, ax = plt.subplots()
        coll = mod.circles([0.0, 1.0], [0.5, -0.5], [0.2, 0.3],
                           c=[1.0, 2.0], ax=ax)
        paths.append([p.vertices for p in coll.get_paths()])
        out = tmp_path / f"{mod.__name__.split('.')[0]}.png"
        assert mod.save(fig, str(out), fig_width=3) == str(out)
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        plt.close(fig)
    for a, b in zip(*paths):
        np.testing.assert_array_equal(a, b)


def test_utils_exports_every_reference_name():
    assert set(jutils.__all__) <= set(putils.__all__)
    for name in jutils.__all__:
        assert hasattr(putils, name), name


# -- the network diagram ------------------------------------------------------
def _diagram_net(sspspace_cls, nef, models):
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = sspspace_cls(2, ssp_dim=13, seed=0, length_scale=0.3,
                         domain_bounds=bounds)
    d = space.ssp_dim
    with nef.Network(seed=0) as net:
        vel = nef.Node(lambda t: np.array([0.1, 0.0]), label="velocity")
        init = nef.Node(lambda t: np.zeros(d), label="init")
        pi = models.PathIntegration(space, 30, 0.05,
                                    neuron_type=nef.LIFRate())
        nef.Connection(vel, pi.velocity_input, synapse=None)
        nef.Connection(init, pi.input, synapse=None)
        memory = models.AssociativeMemory(40, d, d, 0.1)
        nef.Connection(pi.output, memory.key_input, synapse=0.05)
        nef.Connection(init, memory.value_input, synapse=None)
        nef.Connection(nef.Node(lambda t: 0.0, label="learn"),
                       memory.learning, synapse=None)
    return net


def _renamed(dot):
    ids = {}
    return re.sub(r"\bn\d+\b",
                  lambda m: ids.setdefault(m.group(0), f"n{len(ids)}"), dot)


def test_network_diagram_equals_jax(tmp_path):
    want = jutils.network_diagram(_diagram_net(JaxHexagonalSSPSpace, jnef,
                                               jmodels))
    net = _diagram_net(HexagonalSSPSpace, pnef, pmodels)
    got = putils.network_diagram(net, device="cpu")
    assert "learned" in want and "doubleoctagon" in want
    assert _renamed(got) == _renamed(want)
    model = pnef.build(net, device="cpu")
    assert _renamed(putils.network_diagram(model)) == _renamed(want)
    dot = putils.process_and_save_diagram(model, str(tmp_path / "net.png"))
    assert open(dot).read() == putils.network_diagram(model)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_network_diagram_builds_on_the_card_by_default():
    net = _diagram_net(HexagonalSSPSpace, pnef, pmodels)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        putils.network_diagram(net)


# -- the demos against the JAX scripts ---------------------------------------
def test_run_pathint_gif_matches_jax(jax_demos, tmp_path):
    args, built, res, _ = _port_demo(ppg, PI_GIF)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ppg.render(res, str(tmp_path / "pi.gif"))
    assert out.getvalue().startswith("saved ")
    proc, traces, jdir = jax_demos["pi_gif"]
    jout = finish(proc)
    assert "saved " in jout and (jdir / "pi.gif").exists()
    assert (tmp_path / "pi.gif").read_bytes()[:6] == b"GIF89a"
    sim, (out_p, osc_p, spike_p) = built["sim"], built["probes"]
    jtr = np.load(traces)
    for name, probe in (("output", out_p), ("oscillators", osc_p)):
        want = jtr[f"s0_p{_probe_index(sim, probe)}"]
        assert want.shape[0] == 5
        assert_close(sim.data[probe], want, spiking=True, what=name)
    want = jtr[f"s0_p{_probe_index(sim, spike_p)}"].reshape(200, -1)
    assert res["spikes"].shape == want.shape and want.any()
    flips = np.mean(res["spikes"] != want)
    assert flips <= RASTER_FLIPS, flips
    assert res["sims"].shape == (5, 15, 15) and res["raster"].shape[1] == 200


def test_run_slam_map_gif_matches_jax(jax_demos, tmp_path):
    args, built, res, _ = _port_demo(pmg, MAP_GIF)
    with contextlib.redirect_stdout(io.StringIO()):
        pmg.render(res, str(tmp_path / "map.gif"))
    proc, traces, jdir = jax_demos["map_gif"]
    jout = finish(proc)
    assert "saved " in jout and (jdir / "map.gif").exists()
    assert (tmp_path / "map.gif").read_bytes()[:6] == b"GIF89a"
    sim = built["sim"]
    jtr = np.load(traces)
    for name, probe in zip(("output", "weights", "encoders"),
                           built["probes"]):
        want = jtr[f"s0_p{_probe_index(sim, probe)}"]
        got = sim.data[probe]
        assert want.shape[0] == 40
        if name == "output":
            got, want = got[:EARLY_FRAMES], want[:EARLY_FRAMES]
        assert_close(got, want, spiking=True, what=name)
    assert res["maps"].shape == res["posterior"].shape == (40, 12, 12)
    assert np.all(np.isfinite(res["maps"]))


def _keys(lines):
    return [re.split(r"[:\-]>?", line)[0] for line in lines]


def test_slam_map_new_matches_jax(jax_demos, tmp_path):
    args, built, res, _ = _port_demo(psm, MAP_NEW + ["--save-dir",
                                                     str(tmp_path)])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        psm.render(res, args.save_dir)
    assert (tmp_path / "slam_map_queries.png").exists()
    proc, traces, jdir = jax_demos["map_new"]
    jout = finish(proc)
    assert (jdir / "slam_map_queries.png").exists()
    jlines = [line for line in jout.splitlines()
              if line.startswith(("tracking", "  map[", "  query",
                                  "  area"))]
    assert _keys(res["lines"]) == _keys(jlines) and len(jlines) == 7
    assert res["lines"] == jlines
    assert out.getvalue().startswith("saved ")
    sim = built["sim"]
    jtr = np.load(traces)
    *probes, inverse_encoders = built["probes"]
    for probe in probes:
        want = jtr[f"s0_p{_probe_index(sim, probe)}"]
        assert_close(sim.data[probe], want, spiking=True, what=str(probe))
    got = sim.data[inverse_encoders]
    want = jtr[f"s0_p{_probe_index(sim, inverse_encoders)}"]
    assert got.shape == want.shape == (1, 550, 55)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= INVERSE_ENCODERS_TOL, err
    inverse = built["memories"][1]
    init = sim.model.learned_init[f"voja_{inverse.voja_conn_index}"]
    for enc in (got, want):
        moved = np.linalg.norm(enc[0] - init) / np.linalg.norm(init)
        assert moved > INVERSE_MOVED, moved


# -- plot_trials_2d ----------------------------------------------------------
def test_plot_trials_bands_equal_jax(tmp_path):
    for seed in ("0", "1"):
        run_port_cli("run_pathint", [
            "--T", "0.5", "--limit", "2", "--pi-n-neurons", "40",
            "--ssp-dim", "19", "--seed", seed, "--save", "--save-dir",
            str(tmp_path), "--device", "cpu"])
    fig, out = run_port_cli("plot_trials_2d", [
        "--data-dir", str(tmp_path), "--out", str(tmp_path / "t.png")])
    assert out.splitlines()[0] == "2 PI trials, 0 SLAM trials"
    assert (tmp_path / "t.png").exists()
    import matplotlib.pyplot as plt
    jpt = jax_cli_module("plot_trials_2d")
    df = jpt.load_trials(str(tmp_path / "pi*_seed_*.npz"))
    for ax, column in zip(fig.axes, ("sims", "error")):
        jfig_, jax_ax = plt.subplots()
        jpt.band(jax_ax, df, column, "PI", jfig.palette[0])
        (line,), (jline,) = ax.lines, jax_ax.lines
        np.testing.assert_array_equal(line.get_xydata(), jline.get_xydata())
        np.testing.assert_array_equal(
            ax.collections[0].get_paths()[0].vertices,
            jax_ax.collections[0].get_paths()[0].vertices)
        plt.close(jfig_)
