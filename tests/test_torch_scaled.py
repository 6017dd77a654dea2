"""The port's scaled-SLAM CLI (sspslam_tpu_torch.experiments.scaled_slam)
against the JAX package's experiments/scaled_slam.py, and the port's top
level against the JAX package's.

Tolerances:
- ``make_world`` at the tiny arguments of
  tests/test_experiments.py::TestScaledSlamSmoke: the path and velocities
  within 1e-12, every input table within 1e-5 of the JAX package's, and the
  same tables again from the port's on-disk cache;
- the CLI, in this process on the CPU: the JAX CLI's JSON keys (its result
  line, the --dp-sweep rows, the anchor record) and finite per-seed errors;
- every name of ``sspslam_tpu.__all__`` exists on ``sspslam_tpu_torch``.
"""

import importlib
import importlib.util
import json
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

import sspslam_tpu as jsp

import sspslam_tpu_torch as psp
from sspslam_tpu_torch.experiments import scaled_slam

REPO = Path(__file__).resolve().parents[1]
WORLD = dict(T=1.2, domain_dim=2, ssp_dim=31, length_scale=0.3,
             n_landmarks=6, view_rad=0.6, limit=2.0)
CLI = ["--device", "cpu", "--T", "0.3", "--domain-dim", "2", "--ssp-dim",
       "31", "--pi-n-neurons", "40", "--mem-n-neurons", "60",
       "--circonv-n-neurons", "20", "--n-landmarks", "6", "--view-rad",
       "0.6", "--limit", "4.0", "--segment-steps", "150",
       "--cleanup-samples", "6", "--decode-grid", "8"]
# the JAX CLI's result keys (experiments/scaled_slam.py:610-633) and its
# --dp-sweep keys (:557-566)
RESULT_KEYS = {"metric", "value", "unit", "agg_steps_per_s",
               "us_per_episode_step", "mfu", "flops_per_step_per_episode",
               "median_err_slam", "per_seed", "T", "config"}
CONFIG_KEYS = {"ssp_dim", "domain_dim", "length_scale", "param_dtype",
               "decode_method", "mem_n_neurons", "pi_n_neurons",
               "n_landmarks", "view_rad", "update_thres", "shift_rate",
               "pes_lr", "voja_lr", "intercept", "gate_mode", "anchor_k"}
SWEEP_KEYS = {"metric", "value", "unit", "vs_baseline", "dp_sweep"}
ROW_KEYS = {"B", "agg_steps_per_s", "mfu", "compile_s"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_scaled_slam", REPO / "experiments" / "scaled_slam.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_world_matches_jax(tmp_path):
    jcli = _jax_cli()
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    spaces = [(sp.HexagonalSSPSpace(2, ssp_dim=31, seed=0,
                                    length_scale=0.3, domain_bounds=bounds),
               sp.SPSpace(6, 25, seed=0)) for sp in (jsp, psp)]
    for seed, scale in ((0, 0.7), (1, 1.3)):
        want = jcli.make_world(Namespace(table_cache="", **WORLD),
                               *spaces[0], seed, scale)
        args = Namespace(table_cache=str(tmp_path), **WORLD)
        for _ in range(2):   # rendered, then read back from the cache
            got = scaled_slam.make_world(args, *spaces[1], seed, scale)
            np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
            assert got[2].keys() == want[2].keys()
            for k in want[2]:
                np.testing.assert_allclose(got[2][k], want[2][k], rtol=0,
                                           atol=1e-5, err_msg=k)
    assert len(list(tmp_path.glob("w*_T1.2_dim2_d25_*_sp0.npz"))) == 2


def _run(capsys, *extra):
    scaled_slam.main(CLI + list(extra))
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1]), lines


def test_cli_json_has_the_jax_keys(capsys, tmp_path):
    """Two seeds with the PI control, then --dp-sweep 1,2."""
    out, lines = _run(capsys, "--seeds", "0,1", "--table-cache",
                      str(tmp_path))
    assert RESULT_KEYS <= out.keys() and CONFIG_KEYS <= out["config"].keys()
    assert out["mfu"] is None and out["device"] == "cpu"
    assert out["mfu_peak_flops"] == 67e12
    assert [e["seed"] for e in out["per_seed"]] == [0, 1]
    for e in out["per_seed"]:
        for name in ("slam", "pi_only"):
            assert np.isfinite(e[name]["median_err"])
            assert np.isfinite(e[name]["final_err"])
    assert out["value"] > 0 and np.isfinite(out["median_err_slam"])
    sweep, lines = _run(capsys, "--seeds", "0", "--no-pi-control",
                        "--table-cache", str(tmp_path), "--dp-sweep", "1,2")
    assert SWEEP_KEYS <= sweep.keys()
    assert [r["B"] for r in sweep["dp_sweep"]] == [1, 2]
    for r in sweep["dp_sweep"]:
        assert ROW_KEYS <= r.keys() and r["agg_steps_per_s"] > 0


def test_cli_anchor_gate(capsys):
    """--gate-mode auto_recovery --anchor-k 2 --probe-gate, int8 storage:
    the anchors and the gate's record in the JSON."""
    out, lines = _run(capsys, "--seeds", "0,1", "--no-pi-control",
                      "--table-cache", "", "--gate-mode", "auto_recovery",
                      "--anchor-k", "2", "--probe-gate", "--param-dtype",
                      "int8")
    assert RESULT_KEYS <= out.keys()
    assert len(out["anchors"]["landmarks"]) == 2
    assert np.isfinite(out["anchors"]["trigger"])
    assert out["config"]["param_dtype"] == "int8"
    for e in out["per_seed"]:
        assert np.isfinite(e["slam"]["median_err"])
        assert {"enters", "recovery_frac", "first_enter_s",
                "final_state"} <= e["gate"].keys()
    assert any(line.startswith("anchors: ") for line in lines)


def test_cli_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaled_slam.main(CLI[2:])


def test_top_level_has_every_reference_name():
    """The reference package's public names all exist on the port (the
    models alias ``networks`` and ``__version__`` included)."""
    missing = [n for n in jsp.__all__ if not hasattr(psp, n)]
    assert not missing
    assert psp.networks is psp.models
    assert psp.__version__ == jsp.__version__
    from sspslam_tpu_torch import (AssociativeMemory,  # noqa: F401
                                   CircularConvolution, Product,
                                   SLAMGatedNetwork, SLAMViewNetwork,
                                   networks)


#: reference names the port does not carry yet (none since the serving
#: bundle, ``ServingModel`` and ``save_bundle``, was ported)
NOT_PORTED = {"nef": set(), "train": set()}


@pytest.mark.parametrize("module", ["nef", "train"])
def test_module_has_every_reference_name(module):
    """Every name in ``sspslam_tpu.<module>.__all__`` exists on
    ``sspslam_tpu_torch.<module>`` and is in its ``__all__``, the serving
    bundle's ``ServingModel`` and ``save_bundle`` included."""
    ref = importlib.import_module(f"sspslam_tpu.{module}")
    port = importlib.import_module(f"sspslam_tpu_torch.{module}")
    want = set(ref.__all__) - NOT_PORTED[module]
    assert NOT_PORTED[module] <= set(ref.__all__)
    assert not [n for n in want if not hasattr(port, n)]
    assert want <= set(port.__all__)
    assert not NOT_PORTED[module] & set(port.__all__)
