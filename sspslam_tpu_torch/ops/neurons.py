"""Neuron models: rate curves, gain/bias solving, and the stateful spiking
LIF update on torch tensors.

Port of :mod:`sspslam_tpu.ops.neurons` (``NeuronType``,
``RectifiedLinear``, ``SpikingRectifiedLinear``, ``LIFRate``, ``LIF``,
``LoihiLIF``, ``QuantizedLIF``; ``SurrogateLIF`` is for training and is not
ported).  ``gain_bias`` and ``rates_np`` are the same host NumPy code, so
both packages build bitwise-equal gains and biases.  ``rates`` and ``step``
take torch tensors of any shape ((n,), (k, n) or (n, k)) on any device.

``LIF.step`` keeps the executor's ``-expm1`` / ``log1p`` forms; the VCO-bank
CUDA kernel (``csrc/vco_scan.cu``) uses the same formulas (``expm1f`` /
``log1pf``) so its plain PyTorch version can share this function.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

__all__ = ["NeuronType", "LIF", "LIFRate", "RectifiedLinear",
           "SpikingRectifiedLinear", "QuantizedLIF", "LoihiLIF"]


@dataclasses.dataclass(frozen=True)
class NeuronType:
    """Base neuron type. ``rates`` is the static response curve used for
    decoder solving; ``step`` advances dynamic state one dt."""

    amplitude: float = 1.0
    spiking: bool = False

    def gain_bias(self, max_rates: np.ndarray, intercepts: np.ndarray):
        raise NotImplementedError

    def rates(self, J: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rates_np(self, J: np.ndarray) -> np.ndarray:
        """Host NumPy twin of ``rates`` for build-time decoder solving."""
        raise NotImplementedError

    def init_state(self, shape, dtype=np.float32):
        """Zero state as host arrays."""
        return {}

    def step(self, state: Dict[str, torch.Tensor], J: torch.Tensor,
             dt: float):
        """Return (new_state, output). Output units: spikes are scaled by
        amplitude/dt so filtered spike trains approximate rates."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class RectifiedLinear(NeuronType):
    """rate = amplitude * max(J, 0)."""

    def gain_bias(self, max_rates, intercepts):
        gain = max_rates / (1.0 - intercepts)
        bias = -intercepts * gain
        return gain, bias

    def rates(self, J):
        return self.amplitude * torch.clamp_min(J, 0.0)

    def rates_np(self, J):
        return self.amplitude * np.maximum(J, 0.0)

    def step(self, state, J, dt):
        return state, self.rates(J)


@dataclasses.dataclass(frozen=True)
class SpikingRectifiedLinear(RectifiedLinear):
    """Integrate-and-fire with a linear response curve."""

    spiking: bool = True

    def init_state(self, shape, dtype=np.float32):
        return {"voltage": np.zeros(shape, dtype)}

    def step(self, state, J, dt):
        v = state["voltage"] + torch.clamp_min(J, 0.0) * dt
        n_spikes = torch.floor(v)
        out = (self.amplitude / dt) * n_spikes
        return {"voltage": v - n_spikes}, out


@dataclasses.dataclass(frozen=True)
class LIFRate(NeuronType):
    """Leaky integrate-and-fire rate approximation:
    rate = amplitude / (tau_ref + tau_rc * log1p(1/(J-1))) for J > 1."""

    tau_rc: float = 0.02
    tau_ref: float = 0.002

    def gain_bias(self, max_rates, intercepts):
        inv = 1.0 / (1.0 - np.exp(
            np.clip((self.tau_ref - 1.0 / np.asarray(max_rates)) / self.tau_rc,
                    None, -1e-15)))
        gain = (inv - 1.0) / (1.0 - np.asarray(intercepts))
        bias = 1.0 - gain * np.asarray(intercepts)
        return gain, bias

    def rates(self, J):
        Jm1 = torch.clamp_min(J - 1.0, 0.0)
        # guard the log for J <= 1 (rate is 0 there)
        r = self.amplitude / (
            self.tau_ref
            + self.tau_rc * torch.log1p(1.0 / torch.clamp_min(Jm1, 1e-12)))
        return torch.where(J > 1.0 + 1e-9, r, torch.zeros_like(r))

    def rates_np(self, J):
        J = np.asarray(J)
        Jm1 = np.maximum(J - 1.0, 0.0)
        r = self.amplitude / (
            self.tau_ref + self.tau_rc * np.log1p(1.0 / np.maximum(Jm1, 1e-12)))
        return np.where(J > 1.0 + 1e-9, r, 0.0)

    def step(self, state, J, dt):
        return state, self.rates(J)


@dataclasses.dataclass(frozen=True)
class LIF(LIFRate):
    """Spiking LIF with refractory period.

    Membrane relaxes toward J with time constant tau_rc; a spike is emitted
    when v crosses 1, v resets, and the neuron is refractory for tau_ref
    (with sub-dt spike-time interpolation, the integration scheme nengo's
    reference LIF uses).
    """

    spiking: bool = True
    min_voltage: float = 0.0

    def init_state(self, shape, dtype=np.float32):
        return {"voltage": np.zeros(shape, dtype),
                "refractory": np.zeros(shape, dtype)}

    def step(self, state, J, dt):
        voltage = state["voltage"]
        refractory = state["refractory"] - dt
        delta_t = torch.clamp(dt - refractory, 0.0, dt)
        voltage = voltage + (J - voltage) * -torch.expm1(-delta_t / self.tau_rc)

        spiked = voltage > 1.0
        # interpolate the spike time within the step for smoother rates
        denom = torch.where(spiked, torch.clamp_min(J - 1.0, 1e-12),
                            torch.ones_like(J))
        overshoot = torch.clamp((voltage - 1.0) / denom, 0.0, 1.0 - 1e-6)
        t_spike = dt + self.tau_rc * torch.log1p(-overshoot)

        out = torch.where(spiked, torch.full_like(voltage, self.amplitude / dt),
                          torch.zeros_like(voltage))
        voltage = torch.where(spiked, torch.zeros_like(voltage),
                              torch.clamp_min(voltage, self.min_voltage))
        refractory = torch.where(spiked, self.tau_ref + t_spike, refractory)
        return {"voltage": voltage, "refractory": refractory}, out


@dataclasses.dataclass(frozen=True)
class LoihiLIF(LIF):
    """Loihi-chip LIF discretisation (the neuron the reference's Loihi
    backends run).

    Differences from the continuous-time ``LIF``: no sub-dt spike-time
    interpolation (spikes land on the dt grid and the membrane resets to 0);
    the refractory period is quantised to ``round(tau_ref/dt)`` whole steps;
    so inter-spike intervals for constant input are exact step counts,
    ``isi = round(tau_ref/dt) + ceil((tau_rc/dt)·log1p(1/(J-1)))``, and the
    static rate curve is ``amplitude / (dt·isi)``.

    ``dt`` is the discretisation step baked into the rate curve; it must
    match the simulator dt.
    """

    dt: float = 0.001

    def _isi_steps_np(self, J):
        j = np.asarray(J, np.float64) - 1.0
        r = np.round(self.tau_ref / self.dt)
        m = np.ceil((self.tau_rc / self.dt)
                    * np.log1p(1.0 / np.maximum(j, 1e-12)))
        return r + m

    def rates_np(self, J):
        isi = self._isi_steps_np(J)
        r = self.amplitude / (self.dt * isi)
        return np.where(np.asarray(J) > 1.0 + 1e-9, r, 0.0)

    def rates(self, J):
        j = torch.clamp_min(J - 1.0, 1e-12)
        rq = round(self.tau_ref / self.dt)
        m = torch.ceil((self.tau_rc / self.dt) * torch.log1p(1.0 / j))
        r = self.amplitude / (self.dt * (rq + m))
        return torch.where(J > 1.0 + 1e-9, r, torch.zeros_like(r))

    def step(self, state, J, dt):
        voltage = state["voltage"]
        refractory = state["refractory"] - dt
        delta_t = torch.clamp(dt - refractory, 0.0, dt)
        voltage = voltage + (J - voltage) * -torch.expm1(-delta_t / self.tau_rc)
        spiked = voltage > 1.0
        out = torch.where(spiked, torch.full_like(voltage, self.amplitude / dt),
                          torch.zeros_like(voltage))
        voltage = torch.where(spiked, torch.zeros_like(voltage),
                              torch.clamp_min(voltage, self.min_voltage))
        tau_ref_q = float(dt * np.round(self.tau_ref / dt))
        refractory = torch.where(spiked,
                                 torch.full_like(refractory, tau_ref_q + dt),
                                 refractory)
        return {"voltage": voltage, "refractory": refractory}, out


@dataclasses.dataclass(frozen=True)
class QuantizedLIF(LIF):
    """LIF with its voltage rounded to ``levels`` levels in [0, 1] after
    every step, emulating the fixed-point state of neuromorphic hardware."""

    levels: int = 256

    def step(self, state, J, dt):
        q = float(self.levels)
        state, out = LIF.step(self, state, J, dt)
        v = torch.round(state["voltage"] * q) / q
        return {"voltage": v, "refractory": state["refractory"]}, out
