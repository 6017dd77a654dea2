"""ctypes bindings for the native host library (``csrc/host_ops.cpp``).

Port of :mod:`sspslam_tpu.native`.  The library is compiled by ``g++`` (the
JAX package's Makefile flags) into the git-ignored ``build/torch_kernels/``
at first use, or by ``python -m sspslam_tpu_torch.native.build``.  Every
function keeps its NumPy fallback, so the package works without a C++
compiler; ``AVAILABLE`` reports whether the library is loaded.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["AVAILABLE", "argmax_decode", "build", "lif_rates",
           "lowpass_filter", "nearest_landmark", "rd_sampling",
           "stretch_trajectory"]

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host_ops.cpp"
_LIB_PATH = (Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
             / "libsspslam_host.so")
_CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-shared",
              "-std=c++17")

_lib = None
_build_failed = False


def _compile(verbose: bool = False) -> bool:
    """Compile the library into ``_LIB_PATH``; True on success."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return False
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=not verbose)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _load(build_missing: bool = True):
    """The loaded library, compiled first if it is missing or older than
    its source (unless ``build_missing`` is False); None if that fails."""
    global _lib, _build_failed, AVAILABLE
    if _lib is not None:
        return _lib
    fresh = (_LIB_PATH.exists()
             and _LIB_PATH.stat().st_mtime >= _SOURCE.stat().st_mtime)
    if not fresh:
        if not build_missing or _build_failed:
            return None
        if not _compile():
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    f32 = ctypes.c_float
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rd_sampling.argtypes = [i64, i64, f64, pd]
    lib.stretch_trajectory.argtypes = [pd, i64, i64, f64, f64, pd, i64]
    lib.nearest_landmark.argtypes = [pd, i64, i64, i64, f64, pi, pd]
    lib.argmax_decode.argtypes = [pf, i64, i64, pf, i64, pi]
    lib.lowpass_filter.argtypes = [pf, i64, i64, f32, pf]
    lib.lif_rates.argtypes = [pf, i64, f32, f32, f32, pf]
    for f in (lib.rd_sampling, lib.stretch_trajectory, lib.nearest_landmark,
              lib.argmax_decode, lib.lowpass_filter, lib.lif_rates):
        f.restype = None
    _lib = lib
    AVAILABLE = True
    return lib


def build(verbose: bool = False) -> bool:
    """Compile the library anew and load it; returns True on success."""
    global _lib, _build_failed
    _lib, _build_failed = None, False
    if not _compile(verbose):
        _build_failed = True
        return False
    return _load() is not None


#: True once the library is loaded: at import when an up-to-date build is
#: present, otherwise after the first call that builds it
AVAILABLE = _load(build_missing=False) is not None


# -- NumPy fallbacks (the JAX package's) -------------------------------------
def _rd_sampling_np(n, d, seed):
    from ..utils.sampling import Rd_sampling
    return Rd_sampling(n, d, seed)


def _stretch_trajectory_np(traj, n1, original_dt):
    n0, dim = traj.shape
    t_orig = np.linspace(0, n0 * original_dt, n0)
    t_new = np.linspace(0, n0 * original_dt, n1)
    return np.stack([np.interp(t_new, t_orig, traj[:, j])
                     for j in range(dim)], axis=1)


def _nearest_landmark_np(vecs, view_rad):
    T = vecs.shape[0]
    dists = np.linalg.norm(vecs, axis=2)
    nearest = np.argmin(dists, axis=1)
    nd = dists[np.arange(T), nearest]
    return np.where(nd <= view_rad, nearest, -1), nd


def _argmax_decode_np(data, bank):
    return np.argmax(data @ bank.T, axis=1).astype(np.int64)


def _lowpass_filter_np(x, a):
    y = np.empty_like(x)
    acc = np.zeros(x.shape[1], np.float32)
    b = 1 - a
    for t in range(x.shape[0]):
        acc = a * acc + b * x[t]
        y[t] = acc
    return y


def _lif_rates_np(J, tau_rc, tau_ref, amplitude):
    Jm1 = np.maximum(J - 1.0, 1e-12)
    r = amplitude / (tau_ref + tau_rc * np.log1p(1.0 / Jm1))
    return np.where(J > 1.0 + 1e-9, r, 0.0).astype(np.float32)


# -- the functions -------------------------------------------------------------
def rd_sampling(n: int, d: int, seed: float = 0.5) -> np.ndarray:
    lib = _load()
    if lib is None:
        return _rd_sampling_np(n, d, seed)
    out = np.empty((n, d), np.float64)
    lib.rd_sampling(n, d, seed, out)
    return out


def stretch_trajectory(traj: np.ndarray, original_dt: float,
                       new_dt: float) -> np.ndarray:
    traj = np.ascontiguousarray(traj, np.float64)
    n0, dim = traj.shape
    n1 = int(n0 * original_dt / new_dt)
    lib = _load()
    if lib is None:
        return _stretch_trajectory_np(traj, n1, original_dt)
    out = np.empty((n1, dim), np.float64)
    lib.stretch_trajectory(traj, n0, dim, original_dt, new_dt, out, n1)
    return out


def nearest_landmark(vecs: np.ndarray, view_rad: float):
    """vecs (T, L, D) -> (ids (T,), dists (T,)): nearest in-view landmark
    per step (-1 when none)."""
    vecs = np.ascontiguousarray(vecs, np.float64)
    T, L, D = vecs.shape
    lib = _load()
    if lib is None:
        return _nearest_landmark_np(vecs, view_rad)
    ids = np.empty(T, np.int64)
    dists = np.empty(T, np.float64)
    lib.nearest_landmark(vecs, T, L, D, view_rad, ids, dists)
    return ids, dists


def argmax_decode(data: np.ndarray, bank: np.ndarray) -> np.ndarray:
    """Row-wise argmax of data @ bank.T without materialising the (T, M)
    similarity matrix."""
    data = np.ascontiguousarray(data, np.float32)
    bank = np.ascontiguousarray(bank, np.float32)
    T, d = data.shape
    M, d2 = bank.shape
    if d != d2:
        raise ValueError(f"argmax_decode: data has {d} columns, bank {d2}")
    lib = _load()
    if lib is None:
        return _argmax_decode_np(data, bank)
    out = np.empty(T, np.int64)
    lib.argmax_decode(data, T, d, bank, M, out)
    return out


def lowpass_filter(x: np.ndarray, tau: float, dt: float) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    a = np.float32(np.exp(-dt / tau)) if tau > 0 else np.float32(0)
    lib = _load()
    if lib is None:
        return _lowpass_filter_np(x, a)
    y = np.empty_like(x)
    lib.lowpass_filter(x, x.shape[0], x.shape[1], a, y)
    return y


def lif_rates(J: np.ndarray, tau_rc=0.02, tau_ref=0.002,
              amplitude=1.0) -> np.ndarray:
    J = np.ascontiguousarray(J, np.float32)
    lib = _load()
    if lib is None:
        return _lif_rates_np(J, tau_rc, tau_ref, amplitude)
    out = np.empty_like(J)
    lib.lif_rates(J.reshape(-1), J.size, tau_rc, tau_ref, amplitude,
                  out.reshape(-1))
    return out
