"""Operations and bytes, counted from shapes and the reference's own spike
count at the configuration's stated dtype, and the card's peaks.

Nothing here reads the program's trees, so a change to how the program
stores or fuses its tables cannot move these counts.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data-sheet peaks (dense, at 700 W): float32 outside
#: the tensor cores, and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

F32 = 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES)


# The VCO bank's float32 operations (an FMA is two; a division, expm1f or
# log1pf one; compares, selects and min/max are not counted).  Every neuron
# and step: the currents 6, the voltage 3, the refractory update 1.
FLOP_NEURON = 10
# Each spike: the spike time (J - 1, volt - 1, the division, log1pf and its
# FMA, + tau_ref) 7; the one step after it whose decay factor is not a
# constant (dt - refr, the division, expm1f) 3; its five decoder values 5.
FLOP_SPIKE = 15
# Every oscillator and step: the three inputs 4, five filters 15.
FLOP_OSC = 19


def vco_chunk(n, k, d, N, T, spikes) -> dict:
    """One fast-path chunk of T steps (the kernel and its output
    projection) for k oscillators of n neurons whose neurons spike
    ``spikes`` times: its operations, its bytes (each input read once,
    each output written once) and its least time in seconds."""
    flop = (T * k * (n * FLOP_NEURON + FLOP_OSC) + spikes * FLOP_SPIKE
            + 2 * T * k * (2 * d + N)      # the input projections
            + 2 * T * 2 * k * d)           # rows @ [ts0T; ts1T]
    floats_in = (9 * n * k + k             # neuron params, dc_mask
                 + (2 * d + N) * k         # tf0T, tf1T, velT_T
                 + 2 * k * d               # ts0T, ts1T
                 + T * (N + d)             # vel, corr
                 + 2 * n * k + 5 * k)      # state
    floats_out = T * d + 2 * n * k + 5 * k  # SSP trace, state
    nbytes = F32 * (floats_in + floats_out)
    return {"flops": flop, "bytes": nbytes, "least_s": least_s(flop, nbytes),
            "bound_by": ("operations" if flop / PEAK_F32
                         >= nbytes / PEAK_BYTES else "bytes")}
