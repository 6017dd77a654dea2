"""1-byte parameter storage: int8 / fp8 with per-slice scales.

Port of :mod:`sspslam_tpu.ops.quantize`.  The static matmul parameters
(solved decoders, encoders, fixed transforms) are stored as int8 or
float8_e4m3fn with one float32 scale per contracted slice, and the scale is
applied after the contraction:

    act @ (q * s)  ==  (act @ q) * s      when s is constant along the
                                          contracted axis

so the factorisation is exact and the error is the rounding of the weights
alone (at most 0.4 % of the slice amax per int8 weight).  Learned state
(PES decoders, Voja encoders) stays float32: it is rewritten every step.

:class:`QTensor` is registered with ``torch.utils._pytree``, so tree walkers
and ``torch.func.vmap`` see its ``q`` and ``s`` as leaves.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

__all__ = ["QTensor", "quantize", "quant_error"]


class QTensor:
    """Quantised parameter: ``q`` (int8 or float8_e4m3fn) and a float32
    scale ``s`` shaped like ``q`` with the contracted axis removed.

    ``caxis`` is the axis the consuming contraction reduces over: encoders
    and fixed transforms contract their LAST axis, decoders their
    second-to-last (the neuron axis).  The scale is the per-slice symmetric
    amax scale over that axis, so multiplying the contraction's OUTPUT by
    it is exact (the output's trailing axes are the param's non-contracted
    axes, in order, for every contraction of the step)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, caxis: int):
        self.q = q
        self.s = s
        self.caxis = int(caxis)

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def shape(self):
        return self.q.shape

    def dequant(self) -> torch.Tensor:
        """Float32 reconstruction (weights probes, inspection)."""
        return self.q.to(torch.float32) * self.s.to(
            torch.float32).unsqueeze(self.caxis)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.s.to(device), self.caxis)

    def __repr__(self):
        return (f"QTensor(shape={tuple(self.q.shape)}, "
                f"dtype={self.q.dtype}, caxis={self.caxis})")


pytree.register_pytree_node(
    QTensor,
    lambda qt: ([qt.q, qt.s], qt.caxis),
    lambda children, caxis: QTensor(children[0], children[1], caxis),
    serialized_type_name="sspslam_tpu_torch.ops.quantize.QTensor")


def _amax_scale(x: torch.Tensor, caxis: int, qmax: float) -> torch.Tensor:
    amax = torch.amax(torch.abs(x), dim=caxis)
    # an all-zero slice gets scale 1, so it quantises to exact zeros
    # instead of dividing by zero
    return torch.where(amax > 0, amax / qmax,
                       torch.ones_like(amax)).to(torch.float32)


def quantize(x, caxis: int, kind: str = "int8") -> QTensor:
    """Symmetric per-slice quantisation of ``x`` along every axis but
    ``caxis`` (the contraction axis, which shares one scale per slice).

    ``kind``: ``"int8"`` (round half to even onto [-127, 127]) or ``"fp8"``
    (float8_e4m3fn with the slice amax mapped to its maximum, 448).  A
    tensor keeps its device; anything else becomes a CPU tensor."""
    x = torch.as_tensor(x).to(torch.float32)
    caxis = caxis % x.ndim
    if kind == "int8":
        s = _amax_scale(x, caxis, 127.0)
        q = torch.round(x / s.unsqueeze(caxis))
        q = torch.clamp(q, -127, 127).to(torch.int8)
    elif kind == "fp8":
        s = _amax_scale(x, caxis, 448.0)
        q = (x / s.unsqueeze(caxis)).to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quantisation kind: {kind!r}")
    return QTensor(q, s, caxis)


def quant_error(x, caxis: int, kind: str = "int8") -> float:
    """Max reconstruction error relative to the slice amax (a
    diagnostic)."""
    qt = quantize(x, caxis, kind)
    x = torch.as_tensor(x).to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=caxis % x.ndim, keepdim=True)
    err = torch.abs(qt.dequant() - x) / torch.clamp(amax, min=1e-30)
    return float(torch.max(err))
