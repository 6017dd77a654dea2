"""The port's native host library (sspslam_tpu_torch/native, built from
csrc/host_ops.cpp by g++ at first use) and its trace context.

Each of the six functions against its NumPy fallback (tests/test_native.py's
tolerances) and against the JAX package's ``sspslam_tpu.native`` on the
same inputs; the build at first use into an empty directory; and
``utils.profiling.trace_run`` writing a Chrome trace on the CPU.
"""

import glob
import json
import shutil

import numpy as np
import pytest
import torch

from sspslam_tpu import native as jnative

from sspslam_tpu_torch import native
from sspslam_tpu_torch.utils.profiling import trace_run


@pytest.fixture(scope="module", autouse=True)
def built():
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the library cannot be built")
    assert native.build()
    assert native.AVAILABLE


def _inputs(name):
    """(args, kwargs) of ``name`` from a seed."""
    rng = np.random.default_rng(0)
    return {
        "rd_sampling": ((100, 3), {"seed": 0.5}),
        "stretch_trajectory": ((rng.normal(size=(50, 2)), 0.02, 0.001), {}),
        "nearest_landmark": ((rng.normal(size=(200, 5, 2)),),
                             {"view_rad": 1.0}),
        "argmax_decode": ((rng.normal(size=(300, 31)).astype(np.float32),
                           rng.normal(size=(500, 31)).astype(np.float32)),
                          {}),
        "lowpass_filter": ((rng.normal(size=(400, 4)).astype(np.float32),),
                           {"tau": 0.05, "dt": 0.001}),
        "lif_rates": ((np.linspace(-1, 10, 64).astype(np.float32),), {}),
    }[name]


def _fallback(name, args, kw):
    """The port's NumPy fallback of ``name`` on the public arguments."""
    if name == "rd_sampling":
        return native._rd_sampling_np(*args, kw["seed"])
    if name == "stretch_trajectory":
        traj, dt0, dt1 = args
        return native._stretch_trajectory_np(traj, int(len(traj) * dt0 / dt1),
                                             dt0)
    if name == "nearest_landmark":
        return native._nearest_landmark_np(args[0], kw["view_rad"])
    if name == "argmax_decode":
        return native._argmax_decode_np(*args)
    if name == "lowpass_filter":
        a = np.float32(np.exp(-kw["dt"] / kw["tau"]))
        return native._lowpass_filter_np(args[0], a)
    return native._lif_rates_np(args[0], 0.02, 0.002, 1.0)


#: tests/test_native.py's tolerances (exact for the integer outputs)
TOL = {"rd_sampling": (0, 1e-12), "stretch_trajectory": (0, 1e-9),
       "nearest_landmark": (0, 1e-9), "argmax_decode": (0, 0),
       "lowpass_filter": (0, 1e-5), "lif_rates": (2e-4, 1e-3)}


@pytest.mark.parametrize("name", sorted(TOL))
def test_native_matches_fallback_and_jax(name):
    args, kw = _inputs(name)
    got = getattr(native, name)(*args, **kw)
    for want in (_fallback(name, args, kw), getattr(jnative, name)(*args,
                                                                  **kw)):
        rtol, atol = TOL[name]
        for g, w in zip(*(([x] if isinstance(x, np.ndarray) else list(x))
                          for x in (got, want))):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    if name == "nearest_landmark":
        assert (got[0] == -1).any() and (got[0] >= 0).any()


def test_library_builds_at_first_use(tmp_path, monkeypatch):
    """With no library built, the first call compiles it and loads it."""
    lib = tmp_path / "torch_kernels" / "libsspslam_host.so"
    monkeypatch.setattr(native, "_LIB_PATH", lib)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "AVAILABLE", False)
    assert native._load(build_missing=False) is None and not lib.exists()
    out = native.rd_sampling(10, 2)
    assert lib.exists() and native.AVAILABLE and native._lib is not None
    np.testing.assert_allclose(out, native._rd_sampling_np(10, 2, 0.5),
                               atol=1e-12)


def test_trace_run_writes_a_chrome_trace(tmp_path):
    with trace_run(str(tmp_path)) as prof:
        a = torch.ones(64, 64)
        (a @ a).sum()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
