"""The spiking LIF update of one ensemble group as one CUDA kernel for
Hopper, ``csrc/lif_step.cu``, in place of the 30 ATen kernels of
:func:`sspslam_tpu_torch.ops.neurons._lif_step_plain`, with bitwise the same
results.

:func:`engages` says whether a call of ``LIF.step`` takes the kernel, from
what its arguments show: a current on the card, no gradient required, and
no ``torch.func`` transform or ``torch.export`` / ``torch.compile`` trace
around the call (the kernel has no autograd, batching or tracing rule).
Everything else keeps the ATen chain.  On the card :func:`lif_step` takes
float32 tensors of one device, broadcasts them to one shape and makes them
contiguous (no copy where they are already), and raises for another dtype,
a ``dt`` given as a tensor or a card that is not sm_90, as ``vco_scan``
does.  The kernel is compiled with ``nvcc`` at its first launch into
``build/torch_kernels/`` and loaded with ``ctypes``; a launch allocates its
outputs with torch, goes onto the current stream and neither allocates nor
synchronises in the library, so the Simulator's CUDA graphs capture it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import cuda_build

__all__ = ["engages", "lif_step", "build_lif_kernel"]

F32 = torch.float32
_SOURCE = cuda_build.CSRC / "lif_step.cu"
_lib: Optional[ctypes.CDLL] = None
_sm90: Dict[int, bool] = {}


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _require_sm90(device: torch.device) -> None:
    """Raise unless ``device`` is a card the kernel is built for (sm_90)."""
    if device.index not in _sm90:
        _sm90[device.index] = torch.cuda.get_device_capability(device) == (
            9, 0)
    if not _sm90[device.index]:
        raise RuntimeError(
            f"lif_step: the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is not one")


def engages(J: torch.Tensor, voltage: torch.Tensor,
            refractory: torch.Tensor) -> bool:
    """Whether ``LIF.step(state, J, dt)`` runs :func:`lif_step`."""
    xs = (J, voltage, refractory)
    if (not _on_card(J) or torch.compiler.is_compiling()
            or torch._C._functorch.peek_interpreter_stack() is not None
            or any(type(x) is not torch.Tensor for x in xs)):
        return False
    return not (torch.is_grad_enabled() and any(x.requires_grad for x in xs))


def build_lif_kernel() -> Tuple[str, str]:
    """Compile ``csrc/lif_step.cu`` for sm_90a unless this source is built
    already; returns (library path, nvcc's output — '' if it was built)."""
    return cuda_build.build(_SOURCE, "lif_step")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_lif_kernel()[0])
        vp, f32 = ctypes.c_void_p, ctypes.c_float
        lib.lif_step_launch.argtypes = ([vp] * 6 + [ctypes.c_longlong]
                                        + [f32] * 8 + [ctypes.c_int, vp])
        lib.lif_step_launch.restype = ctypes.c_int
        lib.lif_step_error_string.argtypes = [ctypes.c_int]
        lib.lif_step_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _f32(x: float) -> float:
    """``x`` rounded to float32, as ATen takes a Python scalar."""
    return float(np.float32(x))


def lif_step(lif, voltage: torch.Tensor, refractory: torch.Tensor,
             J: torch.Tensor, dt: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One dt of ``lif`` (a ``LIF``) on the card: (voltage, refractory,
    output), new tensors of the arguments' broadcast shape, bitwise what
    the ATen chain gives.  Call it only where :func:`engages` holds."""
    xs = (J, voltage, refractory)
    if isinstance(dt, torch.Tensor):
        raise TypeError("lif_step: dt must be a Python number")
    if any(x.dtype != F32 or x.device != J.device for x in xs):
        got = [(x.dtype, str(x.device)) for x in xs]
        raise TypeError(f"lif_step: the kernel takes float32 tensors on one "
                        f"device (got {got})")
    if not voltage.shape == refractory.shape == J.shape:
        xs = torch.broadcast_tensors(*xs)
    J, voltage, refractory = (x.contiguous() for x in xs)
    v_out = torch.empty_like(voltage)
    r_out = torch.empty_like(refractory)
    out = torch.empty_like(J)
    if J.numel():
        _launch(lif, J, voltage, refractory, v_out, r_out, out, dt)
    return v_out, r_out, out


def _launch(lif, J, voltage, refractory, v_out, r_out, out, dt) -> None:
    """``csrc/lif_step.cu`` on contiguous float32 tensors of one shape."""
    _require_sm90(J.device)
    lib = _load()
    # ATen's CUDA kernel divides a tensor by a Python scalar as a multiply
    # by the scalar's reciprocal, rounded to float32
    inv_tau_rc = _f32(1.0 / lif.tau_rc)
    err = lib.lif_step_launch(
        J.data_ptr(), voltage.data_ptr(), refractory.data_ptr(),
        v_out.data_ptr(), r_out.data_ptr(), out.data_ptr(), J.numel(),
        _f32(dt), inv_tau_rc, _f32(lif.tau_rc), _f32(lif.tau_ref),
        _f32(lif.amplitude / dt), _f32(lif.min_voltage), _f32(1e-12),
        _f32(1.0 - 1e-6), J.device.index,
        torch.cuda.current_stream(J.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lif_step: kernel launch failed with CUDA error "
                           f"{err}: {lib.lif_step_error_string(err).decode()}")
