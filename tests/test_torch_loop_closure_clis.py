"""The port's loop-closure CLIs on the CPU against the JAX package's:
validate_loop_closure, kidnapped_robot, check_anchor_enters and
make_example_paths.

The JAX CLIs run as children (JAX_PLATFORMS=cpu, SSPSLAM_CLEANUP_F32=1,
one thread; ``torch_parity.start_jax_cli``, which records the probe
traces of their Simulators where a test asks); the port's ``main`` runs
in this process, as ``python -m`` calls it.  Held:
- the host-made world equal: paths, velocities, landmark tables, the
  kidnap jump and step, the chosen anchor landmarks, make_example_paths'
  arrays (assert_array_equal); the space's kernel values behind
  ``--auto-derive``'s thresholds within 1e-5;
- traces within the spike-flip bounds of tests/torch_parity.py over the
  first 300 steps: validate_loop_closure's SLAM and PI probes (each
  package builds its own program), and kidnapped_robot ``--in-model
  --anchor`` stepped through both executors on the JAX weights;
- the recovery window's writes in place: every leaf of ``sim.params``
  keeps its tensor and storage; the restored rates equal the saved ones;
- the JSON keys and the printed lines.

The JAX side of the in-process captures is built with
SSPSLAM_HOIST_CLEANUP=1 and SSPSLAM_HOIST_GATE=1 (the port's params
layout).
"""

import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch_parity import (assert_close, finish, jax_cli_module, key_tree,
                          last_json, run_port_cli, start_jax_cli, step_both)

from sspslam_tpu_torch.experiments import kidnapped_robot as pk
from sspslam_tpu_torch.experiments import make_example_paths as pmp
from sspslam_tpu_torch.experiments import validate_loop_closure as pv
from sspslam_tpu_torch.nef import Simulator

STEPS = 300
KERNEL_TOL = 1e-5
TINY = ["--ssp-dim", "25", "--n-landmarks", "6", "--pi-n-neurons", "40",
        "--mem-n-neurons", "60", "--circonv-n-neurons", "10",
        "--view-rad", "0.6"]
# a 0.6 s two-phase world: each phase's WhiteSignal needs high >= 1/T
KIDNAP = [*TINY, "--T", "0.6", "--limit", "4", "--recovery-window", "0.2",
          "--min-jump", "0.4", "--cleanup-samples", "10"]
ANCHOR = ["--in-model", "--anchor", "--anchor-k", "2", "--auto-derive"]


@pytest.fixture(autouse=True)
def hoisted_f32(monkeypatch):
    for name in ("SSPSLAM_HOIST_CLEANUP", "SSPSLAM_HOIST_GATE",
                 "SSPSLAM_CLEANUP_F32"):
        monkeypatch.setenv(name, "1")
    # the port's small ops run fastest on one thread, beside the JAX child
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


class _Built(Exception):
    pass


def jax_kidnap_capture(monkeypatch, argv):
    """Run the JAX kidnapped_robot ``main`` on ``argv`` up to its
    Simulator: returns what it handed its adapters (velocities, vectors to
    the landmarks, anchor landmarks and positions), the kernel values
    behind ``--auto-derive`` and the network."""
    jk = jax_cli_module("kidnapped_robot")
    seen = {"kernel": []}

    def adapter(real, key):
        def wrapped(*a, **k):
            seen[key] = a
            return real(*a, **k)
        return wrapped

    import sspslam_tpu.models as jm

    def kernel(space, r, **k):
        seen["kernel"].append(jk_kernel(space, r, **k))
        return seen["kernel"][-1]

    def simulator(net, **k):
        seen["net"] = net
        raise _Built

    jk_kernel = jk.kernel_value
    for name in ("get_slam_input_functions2", "get_slamview_input_functions"):
        monkeypatch.setattr(jk, name, adapter(getattr(jk, name), "inputs"))
    monkeypatch.setattr(jm, "get_anchor_input_functions",
                        adapter(jm.get_anchor_input_functions, "anchor"))
    monkeypatch.setattr(jk, "kernel_value", kernel)
    monkeypatch.setattr(jk, "Simulator", simulator)
    monkeypatch.setattr(sys, "argv", ["kidnapped_robot.py", *argv])
    with pytest.raises(_Built):
        jk.main()
    return seen


def port_args(argv):
    return pk.parse_args([*argv, "--device", "cpu"])


# -- make_example_paths -----------------------------------------------------
def test_make_example_paths_match_jax(tmp_path, monkeypatch):
    """Both mains write the same two arrays, element for element."""
    jm = jax_cli_module("make_example_paths")
    monkeypatch.setattr(sys, "argv", ["make_example_paths.py", "--out-dir",
                                      str(tmp_path / "jax"), "--seed", "3"])
    jm.main()
    pmp.main(["--out-dir", str(tmp_path / "port"), "--seed", "3"])
    for name in ("twoRooms_path.npy", "oneRoom_path.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))


# -- validate_loop_closure --------------------------------------------------
# the repository's CLI parity widths (tests/test_torch_slam_family.py) on
# a 0.6 s world.  On a faster path (a 0.3 s world at --limit 4) the SLAM
# trace leaves the bounds by step 300 while the PI-only control stays bit
# for bit equal: the clean-up feeds its argmax back into the integrator,
# so one flipped argmax or spike grows (the argmax caveat of ROADMAP.md
# Queue 3)
VALIDATE = ["--ssp-dim", "25", "--n-landmarks", "5", "--pi-n-neurons", "80",
            "--mem-n-neurons", "90", "--circonv-n-neurons", "30", "--T",
            "0.6", "--limit", "2", "--tuned"]


def test_validate_loop_closure_matches_jax(tmp_path):
    """The same world, SLAM and PI-only traces within the spike-flip
    bounds over the first 300 steps, the same lines and JSON keys."""
    traces = tmp_path / "jax.npz"
    proc = start_jax_cli("validate_loop_closure.py", ["--cpu", *VALIDATE],
                         traces=traces)
    result, pout = run_port_cli("validate_loop_closure",
                                [*VALIDATE, "--device", "cpu"])
    sim, probes, path, space, _ = pv.build_program(
        pv.parse_args([*VALIDATE, "--device", "cpu"]))
    sim.run_steps(STEPS)
    jout = finish(proc)
    ref = last_json(jout)
    assert key_tree(result) == key_tree(ref)
    for key in ("T", "ssp_dim", "n_landmarks", "tuned", "seed"):
        assert result[key] == ref[key], key
    jtr = np.load(traces)
    for name, probe in probes.items():
        idx = next(bp.index for bp in sim.model.probes if bp.obj is probe)
        assert_close(sim.data[probe][:STEPS], jtr[f"s0_p{idx}"][:STEPS],
                     spiking=True, what=name)
    lines = {out: out.splitlines() for out in (pout, jout)}
    for prefix in ("build:", "compile:", "sim:", "config:", "model ",
                   "SLAM (loop closure)", "PI only (control)"):
        for out in (pout, jout):
            assert any(line.startswith(prefix) for line in lines[out]), \
                prefix
    assert ([line for line in pout.splitlines() if line.startswith("config")]
            == [line for line in jout.splitlines()
                if line.startswith("config")])


# -- kidnapped_robot --------------------------------------------------------
@pytest.mark.parametrize("extra", [
    ANCHOR,
    ["--in-model", "--auto-derive", "--domain-dim", "3", "--ssp-dim", "41",
     "--length-scale", "0.3", "--decode-grid", "8"],
    ["--model", "view", "--target-jump", "0.7"],
], ids=["anchor", "3d-derived", "view"])
def test_kidnapped_world_matches_jax(monkeypatch, extra):
    """The host-made world the JAX CLI hands its adapters equals the
    port's: velocities (zero at the teleport), vectors to the landmarks,
    the surveyed anchors and their positions, and the space's kernel
    values behind the derived thresholds."""
    argv = [*KIDNAP, *extra]
    seen = jax_kidnap_capture(monkeypatch, argv)
    args = port_args(argv)
    world = pk.make_world(args)
    _, _, jvels, jvec, jvr = seen["inputs"]
    np.testing.assert_array_equal(world["vels"], jvels)
    np.testing.assert_array_equal(world["vec_to_landmarks"], jvec)
    assert jvr == args.view_rad
    assert not world["vels"][world["k_step"]].any()
    if "--anchor" in extra:
        _, jvec, jlms, jlocs, _ = seen["anchor"]
        np.testing.assert_array_equal(world["anchor_lms"], jlms)
        np.testing.assert_array_equal(world["obj_locs"][world["anchor_lms"]],
                                      jlocs)
    if "--auto-derive" in extra:
        got = [world["derived"]["k_half"], world["derived"]["k_full"]]
        np.testing.assert_allclose(got, seen["kernel"], atol=KERNEL_TOL,
                                   rtol=0)
        k_half, k_full = seen["kernel"]
        assert (args.auto_trigger, args.auto_exit, args.auto_cons_trigger) \
            == (round(k_full, 3), round(0.8 * k_half, 3),
                round(0.5 * (k_half + k_full), 3))


# a 1.2 s world kidnapped at step 240, both phases moving (--limit 6).
# Where the strict gate's agreement sits at its threshold the trace is not
# a reference: on a world whose phase A stands still (--limit 4) the JAX
# package's own step under two XLA configurations (this suite's 8-device
# CPU host and a plain one) differs by 0.175 at peak on the strict model's
# PI output, 46 % of the 300 steps above 5 atol, as the port does against
# either
STEP_WORLD = ["--ssp-dim", "25", "--n-landmarks", "5", "--pi-n-neurons",
              "80", "--mem-n-neurons", "90", "--circonv-n-neurons", "30",
              "--view-rad", "0.6", "--T", "1.2", "--kidnap-frac", "0.2",
              "--limit", "6", "--min-jump", "0.4", "--cleanup-samples", "30"]


def test_kidnapped_in_model_steps_match_jax(monkeypatch):
    """``--in-model --anchor``'s three models (the second with the
    auto-recovery gate's stateful node and the beacon channels) through
    both executors on the JAX weights, across the kidnap at step 240:
    every probe within the spike-flip bounds over 300 steps."""
    argv = [*STEP_WORLD, *ANCHOR]
    jnet = jax_kidnap_capture(monkeypatch, argv)["net"]
    args = port_args(argv)
    world = pk.make_world(args)
    assert world["k_step"] == 240
    pnet, handles = pk.build_network(args, world)
    jout, pout, *_ = step_both(jnet, pnet, STEPS)
    assert jout.keys() == pout.keys() and len(jout) == 7
    for k in jout:
        assert_close(pout[k], jout[k], spiking=True, what=f"probe {k}")


def _leaf_ids(tree):
    from sspslam_tpu_torch.nef.simulator import _flatten
    return [(id(x), x.data_ptr()) for x in _flatten(tree)]


def test_recovery_writes_in_place():
    """enter_recovery / exit_recovery write the adaptive model's gate
    table and learning rates in place: every leaf of ``sim.params`` keeps
    its tensor and storage; the strict model's gate is untouched; the
    restored rates equal the clones saved before the zero fill."""
    args = port_args(KIDNAP)
    world = pk.make_world(args)
    net, handles = pk.build_network(args, world)
    sim = Simulator(net, seed=args.seed, device="cpu")
    before = _leaf_ids(sim.params)
    enter, leave, saved = pk.recovery_controls(sim, handles["adaptive"],
                                               args)
    key_of = {n: sim.model.node_info[id(handles[n].update_state)][
        "hoisted_key"] for n in ("strict", "adaptive")}
    assert int(key_of["strict"][1:]) < int(key_of["adaptive"][1:])
    gate = sim.params["hoisted"][key_of["adaptive"]]
    strict = {k: v.clone()
              for k, v in sim.params["hoisted"][key_of["strict"]].items()}
    lr = sim.params["hyper"]["lr"]
    slots = [next(c for c in sim.model.connections
                  if c.obj is conn).learned_slot
             for conn in (handles["adaptive"].assomemory.conn_in,
                          handles["adaptive"].assomemory.conn_out)]
    want = [np.float32(args.voja_lr), np.float32(args.pes_lr)]
    assert [float(lr[k]) for k in slots] == [float(w) for w in want]
    sim.run_steps(10)
    enter()
    assert _leaf_ids(sim.params) == before
    assert float(gate["update_thres"]) == -2.0
    assert float(gate["shift_rate"]) == np.float32(args.recovery_shift_rate)
    assert all(float(lr[k]) == 0.0 for k in slots)
    assert [float(s) for s in saved] == [float(w) for w in want]
    sim.run_steps(10)
    leave()
    assert _leaf_ids(sim.params) == before
    assert float(gate["update_thres"]) == np.float32(args.update_thres)
    assert float(gate["shift_rate"]) == np.float32(args.shift_rate)
    assert [float(lr[k]) for k in slots] == [float(w) for w in want]
    for k, v in sim.params["hoisted"][key_of["strict"]].items():
        assert torch.equal(v, strict[k])
    others = [k for k in lr if k not in slots]
    assert len(others) == 2 and all(float(lr[k]) > 0 for k in others)


def test_kidnapped_cli_matches_jax(tmp_path):
    """``--in-model --anchor --auto-derive --dump``: the JAX CLI and the
    port's print the same world lines and JSON keys, the same jump,
    kidnap, anchors and derived thresholds, and dump the same path;
    check_anchor_enters prints the same lines on the port's dump from
    either package.  The scripted, ``--auto --auto-debug`` and ``--model
    view`` modes run and print the JAX CLI's keys."""
    argv = [*KIDNAP, *ANCHOR]
    proc = start_jax_cli("kidnapped_robot.py",
                         ["--cpu", *argv, "--dump", str(tmp_path / "j.npz")])
    result, pout = run_port_cli("kidnapped_robot",
                                [*argv, "--device", "cpu", "--dump",
                                 str(tmp_path / "p.npz")])
    modes = {name: run_port_cli("kidnapped_robot",
                                [*KIDNAP, *extra, "--device", "cpu"])[0]
             for name, extra in (("scripted", []),
                                 ("auto", ["--auto", "--auto-debug",
                                           "--tick-s", "0.1"]),
                                 ("view", ["--model", "view",
                                           "--in-model"]))}
    jout = finish(proc)
    ref = last_json(jout)
    assert key_tree(result) == key_tree(ref)
    for key in ("model", "domain_dim", "jump", "T", "kidnap_t",
                "recovery_window", "ssp_dim", "anchor",
                "derived_thresholds", "recovered_below"):
        assert result[key] == ref[key], key
    for prefix in ("derived thresholds from the space:", "anchor:"):
        mine = [line for line in pout.splitlines()
                if line.startswith(prefix)]
        assert mine and mine == [line for line in jout.splitlines()
                                 if line.startswith(prefix)], prefix
    for prefix in ("build:", "compile:", "sim:", "dumped monitor traces",
                   "  [in-model] enters=", "teleport distance:"):
        for out in (pout, jout):
            assert any(line.startswith(prefix)
                       for line in out.splitlines()), prefix
    pd, jd = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(pd.files) == sorted(jd.files)
    for key in ("path", "in_view", "skip", "dt", "k_step"):
        np.testing.assert_array_equal(pd[key], jd[key])
    assert pd["pi"].shape == jd["pi"].shape

    plain = {k: v for k, v in result.items()
             if k not in ("auto", "anchor", "derived_thresholds")}
    assert key_tree(modes["scripted"]) == key_tree(plain)
    assert set(modes["auto"]["auto"]) == {
        "events", "false_triggers", "detect_s", "recovery_exit_s"}
    assert modes["view"]["model"] == "view"
    assert set(modes["view"]["auto"]) == set(ref["auto"])

    enters = ["--enters", "0.35", "0.5"]
    check = start_jax_cli("check_anchor_enters.py",
                          [str(tmp_path / "p.npz"), "--seed", "0",
                           "--cpu", *enters])
    _, cout = run_port_cli("check_anchor_enters",
                           [str(tmp_path / "p.npz"), "--seed", "0",
                            "--device", "cpu", *enters])
    cj = finish(check)
    assert len(cout.splitlines()) == 2
    assert cout.splitlines() == cj.splitlines()
