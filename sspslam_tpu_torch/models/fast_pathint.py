"""FastPathIntegrator: path integration with the whole VCO bank in one
CUDA kernel launch per chunk of steps.

Port of :class:`sspslam_tpu.models.fast_pathint.FastPathIntegrator`.  It
builds a regular :class:`PathIntegration` network through the port's NEF
builder (so encoders, gains, biases and decoders come from the same solver
pipeline as the generic path), then runs the VCO-bank dynamics chunk by
chunk through :func:`sspslam_tpu_torch.ops.vco_scan.vco_scan`: the CUDA
kernel on a CUDA device (the default; without a card it raises), its plain
PyTorch version on the CPU (``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..nef import Network, Node, build
from ..ops import vsa
from ..ops.neurons import LIF
from ..ops.vco_scan import (VCOParams, VCOState, initial_vco_state,
                            vco_scan)
from .pathintegration import PathIntegration

__all__ = ["FastPathIntegrator"]


class FastPathIntegrator:
    def __init__(self, ssp_space, n_neurons, recurrent_tau=0.05,
                 scaling_factor=1.0, stable=True, max_radius=1.0,
                 tau_probe=0.05, seed: Optional[int] = 0,
                 chunk_steps: int = 1000, dt: float = 0.001, *,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FastPathIntegrator: device='cuda' but no "
                               "CUDA device is available")
        self.device = device
        self.ssp_space = ssp_space
        self.dt = dt
        self.chunk_steps = chunk_steps
        d = ssp_space.ssp_dim
        N = ssp_space.domain_dim
        self.d, self.N = d, N
        k = (d + 1) // 2
        self.k, self.n = k, n_neurons

        # build through the engine so parameters are identical to the
        # generic path
        with Network(seed=seed) as net:
            Node(size_in=N, output=None, label="vel_stub")
            PathIntegration(ssp_space, n_neurons, recurrent_tau,
                            scaling_factor=scaling_factor, stable=stable,
                            max_radius=max_radius, neuron_type=LIF())
        model = build(net, dt=dt, seed=seed, device=device)
        be = next(b for b in model.ensembles if b.batched)
        rec_bc = next(c for c in model.connections
                      if c.pre_kind == "ea_batch" and c.post_kind == "ea_batch")
        out_bc = next(c for c in model.connections
                      if c.pre_kind == "ea_batch" and c.post_kind == "node")
        a_rec = np.exp(-dt / recurrent_tau)
        a_out = np.exp(-dt / tau_probe)
        nt = be.neuron_type

        def slab(x):  # (k, n, ...) host array or device tensor -> (n, k)
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
            return x.T.contiguous()

        enc = torch.as_tensor(be.scaled_encoders, dtype=torch.float32,
                              device=device)                 # (k, n, 3)
        drec = torch.as_tensor(rec_bc.decoders, dtype=torch.float32,
                               device=device)                # (k, n, 3)
        dout = torch.as_tensor(out_bc.decoders, dtype=torch.float32,
                               device=device)                # (k, n, 3)
        tof = vsa.to_fourier_matrix(d)    # (3k, d)
        fromf = vsa.from_fourier_matrix(d)  # (d, 3k)
        dc_mask = torch.zeros((1, k), dtype=torch.float32, device=device)
        dc_mask[0, 0] = 1.0
        self.params = VCOParams(
            enc0=slab(enc[:, :, 0]), enc1=slab(enc[:, :, 1]),
            enc2=slab(enc[:, :, 2]), bias=slab(be.bias),
            drec0=slab(drec[:, :, 0]), drec1=slab(drec[:, :, 1]),
            drec2=slab(drec[:, :, 2]),
            dout0=slab(dout[:, :, 0]), dout1=slab(dout[:, :, 1]),
            velT_T=slab(ssp_space.phase_matrix[:k]),
            tf0T=slab(tof[0::3, :]), tf1T=slab(tof[1::3, :]),
            ts0T=slab(fromf[:, 0::3]), ts1T=slab(fromf[:, 1::3]),
            dc_mask=dc_mask,
            a_rec=float(a_rec), b_rec=float(1 - a_rec),
            a_out=float(a_out), b_out=float(1 - a_out),
            tau_rc=float(nt.tau_rc), tau_ref=float(nt.tau_ref), dt=float(dt),
        )
        self.state = self.initial_state()

    def initial_state(self) -> VCOState:
        """Zero state; ``fout`` holds the filtered (1, 2k) decode rows (the
        projection to SSP space happens after the kernel)."""
        return initial_vco_state(self.n, self.k, device=self.device)

    def run(self, velocities: np.ndarray,
            corrections: Optional[np.ndarray] = None,
            transfer: bool = True):
        """Integrate a (T, N) velocity table (optionally with (T, d) SSP
        corrections, e.g. the initial-state clamp); returns the (T, d)
        filtered SSP estimate trace as a NumPy array (``transfer=False``:
        the list of per-chunk traces left on the device, after waiting for
        the device to finish)."""
        # one upload of the whole input table: a synchronous per-chunk copy
        # would make every launch wait for the previous chunk to finish
        vel = torch.as_tensor(np.asarray(velocities, np.float32),
                              device=self.device)
        T = vel.shape[0]
        if corrections is None:
            corr = torch.zeros((min(self.chunk_steps, T), self.d),
                               dtype=torch.float32, device=self.device)
        else:
            corr = torch.as_tensor(np.asarray(corrections, np.float32),
                                   device=self.device)
        outs = []
        done = 0
        while done < T:
            c = min(self.chunk_steps, T - done)
            cc = corr[:c] if corrections is None else corr[done:done + c]
            self.state, out = vco_scan(self.params, self.state,
                                       vel[done:done + c], cc)
            # chunk traces stay on the device; one device->host copy below
            outs.append(out)
            done += c
        if not transfer:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return outs
        return torch.cat(outs, dim=0).cpu().numpy()
