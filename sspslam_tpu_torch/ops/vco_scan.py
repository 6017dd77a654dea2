"""The VCO-bank chunk scan: the path integrator's hot loop as one CUDA
kernel for Hopper, beside its plain PyTorch version.

Counterpart of :mod:`sspslam_tpu.ops.pallas_kernels`, whose two Pallas
kernels (``make_vco_scan_v2`` / ``_chunk_body_v2`` and ``make_vco_scan`` /
``_chunk_body``) this module replaces with one kernel,
``csrc/vco_scan.cu``, with v2's contract: T dt-steps of the k-oscillator
LIF bank per launch, the two input projections inside the launch, and the
FILTERED (T, 2k) output decode rows as its result.  The SSP output
``rows @ [ts0T; ts1T]`` is a matmul after the kernel; since filtering and
projection commute it is v1's (T, d) output as well.

:func:`vco_scan` dispatches on the device of the tensors it is given: CPU
tensors take the plain version :func:`vco_scan_reference`; CUDA tensors
launch the kernel or raise.  The kernel is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/torch_kernels/`` beside the package and
loaded with ``ctypes``.  It runs each oscillator on a thread-block cluster
of C CTAs; :func:`_cluster_size` picks C.

Layouts are the JAX package's: (n, k) neuron slabs and (1, k) rows.  The
oscillator axis is NOT padded to 128 lanes (that was a rule of the TPU's
tile); :func:`vco_params_from_numpy` drops such padding when it carries
JAX parameters across.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from . import cuda_build
from .neurons import LIF, _lif_step_plain

__all__ = ["VCOParams", "VCOState", "initial_vco_state", "output_projection",
           "vco_reference_step", "vco_scan_reference", "vco_scan",
           "vco_params_from_numpy", "vco_state_from_numpy",
           "build_vco_kernel"]

F32 = torch.float32

ARRAY_FIELDS = ("enc0", "enc1", "enc2", "bias", "drec0", "drec1", "drec2",
                "dout0", "dout1", "velT_T", "tf0T", "tf1T", "ts0T", "ts1T",
                "dc_mask")
CONST_FIELDS = ("a_rec", "b_rec", "a_out", "b_out", "tau_rc", "tau_ref", "dt")


class VCOParams(NamedTuple):
    """Static per-model parameters (float32 tensors, all 2-D, one device).

    enc0/1/2 : (n, k) scaled encoders per state component
    bias : (n, k)
    drec0/1/2 : (n, k) recurrent decoders (DC oscillator column zeroed)
    dout0/1 : (n, k) output (identity) decoders, Re/Im components
    velT_T : (N, k) velocity -> per-VCO frequency projection
    tf0T/tf1T : (d, k) SSP-correction -> per-VCO Re/Im projection
    ts0T/ts1T : (k, d) per-VCO Re/Im -> SSP reconstruction
    dc_mask : (1, k) one-hot on the DC oscillator (its [1,0,0] pin)
    """
    enc0: torch.Tensor
    enc1: torch.Tensor
    enc2: torch.Tensor
    bias: torch.Tensor
    drec0: torch.Tensor
    drec1: torch.Tensor
    drec2: torch.Tensor
    dout0: torch.Tensor
    dout1: torch.Tensor
    velT_T: torch.Tensor
    tf0T: torch.Tensor
    tf1T: torch.Tensor
    ts0T: torch.Tensor
    ts1T: torch.Tensor
    dc_mask: torch.Tensor
    a_rec: float
    b_rec: float
    a_out: float
    b_out: float
    tau_rc: float
    tau_ref: float
    dt: float


class VCOState(NamedTuple):
    voltage: torch.Tensor     # (n, k)
    refractory: torch.Tensor  # (n, k)
    f0: torch.Tensor          # (1, k) filtered recurrent Re
    f1: torch.Tensor          # (1, k) filtered recurrent Im
    f2: torch.Tensor          # (1, k) filtered recurrent freq
    fout: torch.Tensor        # (1, 2k) filtered output decode rows [Re | Im]


def initial_vco_state(n: int, k: int, *, device) -> VCOState:
    def z(*shape):
        return torch.zeros(shape, dtype=F32, device=device)
    return VCOState(z(n, k), z(n, k), z(1, k), z(1, k), z(1, k), z(1, 2 * k))


def output_projection(params: VCOParams) -> torch.Tensor:
    """(2k, d) map from the filtered decode rows to the SSP."""
    return torch.cat([params.ts0T, params.ts1T], dim=0)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the same formulas as the kernel)
# ---------------------------------------------------------------------------

def _vco_step(p: VCOParams, lif: LIF, s: VCOState, xc0, xc1, xv) -> VCOState:
    """One dt of the VCO bank given this step's projected inputs (1, k);
    the LIF update is the chain of torch ops on every device, so the
    kernel is held to a version with no hand-written kernel in it."""
    x0 = s.f0 + xc0 + p.dc_mask
    x1 = s.f1 + xc1
    x2 = s.f2 + xv
    J = p.enc0 * x0 + p.enc1 * x1 + p.enc2 * x2 + p.bias
    neurons, act = _lif_step_plain(lif, {"voltage": s.voltage,
                                         "refractory": s.refractory}, J, p.dt)

    def decode(D):
        return torch.sum(act * D, dim=0, keepdim=True)

    f0 = p.a_rec * s.f0 + p.b_rec * decode(p.drec0)
    f1 = p.a_rec * s.f1 + p.b_rec * decode(p.drec1)
    f2 = p.a_rec * s.f2 + p.b_rec * decode(p.drec2)
    rows = torch.cat([decode(p.dout0), decode(p.dout1)], dim=1)
    fout = p.a_out * s.fout + p.b_out * rows
    return VCOState(neurons["voltage"], neurons["refractory"], f0, f1, f2,
                    fout)


def _lif(p: VCOParams) -> LIF:
    return LIF(tau_rc=p.tau_rc, tau_ref=p.tau_ref)


def vco_reference_step(params: VCOParams, state: VCOState, vel, corr):
    """One dt with per-step projections (port of
    ``pallas_kernels.vco_reference_step``): vel (N,), corr (d,) ->
    (new_state, filtered SSP (d,))."""
    vel = torch.as_tensor(vel, dtype=F32, device=params.bias.device)
    corr = torch.as_tensor(corr, dtype=F32, device=params.bias.device)
    vel, corr = vel.reshape(1, -1), corr.reshape(1, -1)
    state = _vco_step(params, _lif(params), state, corr @ params.tf0T,
                      corr @ params.tf1T, vel @ params.velT_T)
    return state, (state.fout @ output_projection(params))[0]


def vco_scan_reference(params: VCOParams, state: VCOState,
                       vel_chunk: torch.Tensor, corr_chunk: torch.Tensor
                       ) -> Tuple[VCOState, torch.Tensor]:
    """Plain PyTorch version of the kernel: the chunk's projections as two
    matmuls, then a Python loop over its T steps.
    vel_chunk (T, N), corr_chunk (T, d) -> (new_state, SSP trace (T, d))."""
    xc0 = corr_chunk @ params.tf0T
    xc1 = corr_chunk @ params.tf1T
    xv = vel_chunk @ params.velT_T
    lif = _lif(params)
    rows = []
    for t in range(vel_chunk.shape[0]):
        state = _vco_step(params, lif, state, xc0[t:t + 1], xc1[t:t + 1],
                          xv[t:t + 1])
        rows.append(state.fout)
    return state, torch.cat(rows, dim=0) @ output_projection(params)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_SOURCE = cuda_build.CSRC / "vco_scan.cu"
#: csrc/vco_scan.cu: at most 4 neurons per thread, 512 threads per CTA
_MAX_NEURONS = 4 * 512
#: CTAs per oscillator (one thread-block cluster) the kernel is built for
CLUSTER_SIZES = (1, 4)
_lib: Optional[ctypes.CDLL] = None


def _cluster_size(n: int, k: int, num_sms: int) -> int:
    """CTAs per oscillator for k oscillators of n neurons on a card with
    ``num_sms`` SMs: 4 for at most 92 oscillators per 132 SMs (and n >= 4,
    so no CTA is without a neuron), else 1.

    Measured on an H100 (132 SMs, n = 800; chip_smoke.py's sweep,
    PERF.md): C = 4 is faster up to k = 92, where the clusters of 4 that
    fit at once end, and slower from k = 93 to 401 but for k = 133.
    Other SM counts scale the edge; that is not measured."""
    return 4 if 4 <= n and 132 * k <= 92 * num_sms else 1


def build_vco_kernel() -> Tuple[str, str]:
    """Compile ``csrc/vco_scan.cu`` for sm_90a unless this source is built
    already; returns (library path, nvcc's output — '' if it was built)."""
    return cuda_build.build(_SOURCE, "vco_scan")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_vco_kernel()[0])
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vco_scan_launch.argtypes = ([vp, vp] + [i32] * 5 + [f32] * 8
                                        + [i32, i32, vp])
        lib.vco_scan_launch.restype = i32
        lib.vco_scan_error_string.argtypes = [i32]
        lib.vco_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, x, shape, device):
    if x.device != device or x.dtype != F32 or not x.is_contiguous():
        raise ValueError(f"vco_scan: {name} must be a contiguous float32 "
                         f"tensor on {device} (got {x.dtype} on {x.device})")
    if tuple(x.shape) != shape:
        raise ValueError(f"vco_scan: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")


def _vco_scan_cuda(p: VCOParams, state: VCOState, vel: torch.Tensor,
                   corr: torch.Tensor, *, cluster: Optional[int] = None
                   ) -> Tuple[VCOState, torch.Tensor]:
    """The kernel launch; ``cluster`` (CTAs per oscillator, one of
    ``CLUSTER_SIZES``) defaults to :func:`_cluster_size`'s choice."""
    device = vel.device
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError(
            f"vco_scan: the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is not one")
    n, k = p.bias.shape
    d = p.tf0T.shape[0]
    T, N = vel.shape
    if not 1 <= n <= _MAX_NEURONS or T < 1:
        raise ValueError(f"vco_scan: the kernel takes 1..{_MAX_NEURONS} "
                         f"neurons per oscillator and T >= 1 (got n={n}, "
                         f"T={T})")
    if cluster is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        cluster = _cluster_size(n, k, sms)
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"vco_scan: cluster must be one of {CLUSTER_SIZES} "
                         f"(got {cluster})")
    shapes = {"enc0": (n, k), "enc1": (n, k), "enc2": (n, k),
              "bias": (n, k), "drec0": (n, k), "drec1": (n, k),
              "drec2": (n, k), "dout0": (n, k), "dout1": (n, k),
              "velT_T": (N, k), "tf0T": (d, k), "tf1T": (d, k),
              "dc_mask": (1, k)}
    for name, shape in shapes.items():
        _check(name, getattr(p, name), shape, device)
    _check("vel_chunk", vel, (T, N), device)
    _check("corr_chunk", corr, (T, d), device)
    state_shapes = ((n, k), (n, k), (1, k), (1, k), (1, k), (1, 2 * k))
    for name, x, shape in zip(VCOState._fields, state, state_shapes):
        _check(name, x, shape, device)

    lib = _load()
    rows = torch.empty((T, 2 * k), dtype=F32, device=device)
    new = VCOState(*(torch.empty_like(x) for x in state))
    scratch = torch.empty((k, 3, T), dtype=F32, device=device)
    ins = [getattr(p, f) for f in ARRAY_FIELDS[:9]] + [
        p.dc_mask, p.tf0T, p.tf1T, p.velT_T, vel, corr, *state]
    outs = [rows, *new, scratch]
    in_ptrs = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    err = lib.vco_scan_launch(
        in_ptrs, out_ptrs, n, k, d, N, T, p.a_rec, p.b_rec, p.a_out,
        p.b_out, p.tau_rc, p.tau_ref, p.dt, 1.0 / p.dt, cluster,
        device.index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vco_scan: kernel launch failed with CUDA error "
                           f"{err}: {lib.vco_scan_error_string(err).decode()}")
    profiling.count("vco_scan.launches")
    return new, rows @ output_projection(p)


def vco_scan(params: VCOParams, state: VCOState, vel_chunk: torch.Tensor,
             corr_chunk: torch.Tensor) -> Tuple[VCOState, torch.Tensor]:
    """T dt-steps of the VCO bank: vel_chunk (T, N), corr_chunk (T, d) ->
    (new_state, filtered SSP trace (T, d)).  CUDA tensors launch the
    kernel (the counter ``vco_scan.launches`` of ``utils.profiling``
    counts the launches); CPU tensors take :func:`vco_scan_reference`.
    Each call is the span ``vco_scan.call`` while tracing: on the card the
    host's part only (checks, the launch, the projection's enqueue)."""
    with profiling.span("vco_scan.call"):
        if vel_chunk.device.type == "cuda":
            return _vco_scan_cuda(params, state, vel_chunk, corr_chunk)
        if vel_chunk.device.type == "cpu":
            return vco_scan_reference(params, state, vel_chunk, corr_chunk)
        raise ValueError(f"vco_scan: no path for device {vel_chunk.device}")


# ---------------------------------------------------------------------------
# Carrying parameters and state across from the JAX package
# ---------------------------------------------------------------------------

def _unpad(name, a, k, axis):
    a = np.asarray(a, np.float32)
    pad = np.take(a, np.arange(k, a.shape[axis]), axis=axis)
    if np.any(pad != 0):
        raise ValueError(f"{name}: lane-padding beyond k={k} is not zero")
    return np.take(a, np.arange(k), axis=axis)


def vco_params_from_numpy(arrays: Mapping[str, np.ndarray],
                          consts: Mapping[str, float], *,
                          device) -> VCOParams:
    """The port's params from the fields of a JAX ``VCOParams`` given as
    NumPy arrays (``arrays``) and floats (``consts``), lane-padded or not:
    oscillator columns at index >= (d+1)//2 must be zero and are dropped."""
    d = np.shape(arrays["ts0T"])[1]
    k = (d + 1) // 2
    out = {}
    for name in ARRAY_FIELDS:
        axis = 0 if name in ("ts0T", "ts1T") else 1
        out[name] = torch.tensor(_unpad(name, arrays[name], k, axis),
                                 dtype=F32, device=device)
    out.update({name: float(consts[name]) for name in CONST_FIELDS})
    return VCOParams(**out)


def vco_state_from_numpy(arrays: Mapping[str, np.ndarray], k: int, *,
                         device) -> VCOState:
    """The port's state from a JAX v2 ``VCOState`` given as NumPy arrays:
    padding columns dropped (a silent padding neuron's refractory clock
    still runs down, so they need not be zero), ``fout`` taken as the
    filtered (1, 2kp) decode rows [Re | Im] of the v2 kernel."""
    out = {name: np.asarray(arrays[name], np.float32)[:, :k]
           for name in ("voltage", "refractory", "f0", "f1", "f2")}
    fout = np.asarray(arrays["fout"], np.float32)
    kp = fout.shape[1] // 2
    out["fout"] = np.concatenate([fout[:, :k], fout[:, kp:kp + k]], axis=1)
    return VCOState(**{name: torch.tensor(a, dtype=F32, device=device)
                       for name, a in out.items()})
