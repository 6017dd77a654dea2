"""Operations and bytes of one SLAM step, counted from the reference's
shapes (:mod:`benchmark.reference.slam`) at the configuration's stated
dtypes, and the step's least time on the card's peaks.

Each term is a contraction of the step, an element-wise map or an update
of its learned leaves: (name, multiply-adds, bytes it must move).  A
multiply-add is two operations; a table is read once a step, a learned
leaf read and written once (its update's bytes: the contraction that reads
it too moves none of its own), every neuron's state read and written once,
and the vectors between them not at all.  The program's dead
work (a decode nothing reads) is not counted; nothing here reads the
program, so a change to how it stores or fuses its tables cannot move
these counts.
"""

from __future__ import annotations

from .counts import F32, least_s

BF16 = 2
#: float32 operations a LIF neuron takes a step (the currents' bias add,
#: the voltage's decay and update, the refractory update and clamps; the
#: spike time's few more per spike are not counted)
FLOP_NEURON = 10


def shapes(cfg: dict) -> dict:
    d = cfg["ssp_dim"]
    h4 = 4 * (d // 2 + 1)
    return {"d": d, "k": (d + 1) // 2, "n_pi": cfg["pi_n_neurons"],
            "n_mem": cfg["mem_n_neurons"], "h4": h4, "sq": 2 * h4,
            "n_sq": max(1, cfg["circonv_n_neurons"] // 2),
            "grid": cfg["cleanup_samples_per_dim"] ** cfg["domain_dim"],
            "N": cfg["domain_dim"]}


def terms(cfg: dict) -> list:
    """(name, multiply-adds, bytes) of every contraction and update of
    one step."""
    s = shapes(cfg)
    d, k, n_pi, n_mem = s["d"], s["k"], s["n_pi"], s["n_mem"]
    h4, sq, n_sq = s["h4"], s["sq"], s["n_sq"]

    def gemv(rows, cols, width=F32):
        return rows * cols, rows * cols * width

    def learned(rows, cols):
        return rows * cols, 0

    def elementwise(n):
        return n, 0

    out = [
        ("vco.encoders", *gemv(k * n_pi, 3)),
        ("vco.decoders", *gemv(k * n_pi, 6)),          # output, recurrence
        ("vco.dft", *gemv(3 * k, d)),                  # to the oscillators
        ("vco.idft", *gemv(d, 3 * k)),                 # back to the SSP
        ("vco.velocity", *gemv(k, s["N"])),
        ("memory.encoders", *learned(n_mem, d)),       # Voja's
        ("ovc_recall_error.encoders", *gemv(3 * n_mem, d)),
        ("group.decoders", *gemv(5 * n_mem, d)),       # ids and unitaries
        ("memory.pes_decode", *learned(n_mem, d)),     # PES's
        ("cleanup.scores", *gemv(s["grid"], d, BF16)),
    ]
    for cc in ("cc1", "cc2"):
        out += [(f"{cc}.dft_in", *gemv(2 * h4, d)),     # both operands
                (f"{cc}.align", *elementwise(sq)),       # (a +- b) / sqrt 2
                (f"{cc}.encoders", *gemv(sq * n_sq, 1)),
                (f"{cc}.decoders", *gemv(sq * n_sq, 1)),
                (f"{cc}.fold", *elementwise(h4)),        # (w - x, y + z)
                (f"{cc}.idft", *gemv(d, h4))]
    # learned leaves: each element read and written; PES one multiply-add
    # an element (after the outer product's multiply), Voja three
    out += [("pes.update", 2 * n_mem * d, 2 * n_mem * d * F32),
            ("voja.update", 4 * n_mem * d, 2 * n_mem * d * F32)]
    return out


def neurons(cfg: dict) -> int:
    s = shapes(cfg)
    return (s["k"] * s["n_pi"] + 4 * s["n_mem"]
            + 2 * s["sq"] * s["n_sq"])


def step(cfg: dict) -> dict:
    """One step's operations, bytes and least time in seconds."""
    t = terms(cfg)
    n = neurons(cfg)
    flops = 2 * sum(m for _, m, _ in t) + FLOP_NEURON * n
    nbytes = sum(b for _, _, b in t) + 2 * 2 * n * F32  # voltage, refractory
    return {"flops": flops, "bytes": nbytes, "least_s": least_s(flops,
                                                                nbytes),
            "neurons": n}
