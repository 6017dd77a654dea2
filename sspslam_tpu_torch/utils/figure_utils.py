"""Figure styling and saving helpers (a copy of
:mod:`sspslam_tpu.utils.figure_utils`: Tango palette, circle patches,
cropped-PDF save — the Ghostscript crop is skipped when gs is absent).
matplotlib is imported inside the functions that draw."""

from __future__ import annotations

import os
import subprocess

import numpy as np

# Tango colour scheme
blues = ["#729fcf", "#3465a4", "#204a87"]
greens = ["#8ae234", "#73d216", "#4e9a06"]
reds = ["#ef2929", "#cc0000", "#a40000"]
oranges = ["#fcaf3e", "#f57900", "#ce5c00"]
purples = ["#ad7fa8", "#75507b", "#5c3566"]
yellows = ["#fce94f", "#edd400", "#c4a000"]
browns = ["#e9b96e", "#c17d11", "#8f5902"]
greys = ["#eeeeec", "#d3d7cf", "#babdb6", "#888a85", "#555753", "#2e3436"]
palette = [blues[1], oranges[1], greens[2], reds[1], purples[1],
           browns[1], yellows[2], greys[3]]


def use_publication_style(usetex=None):
    """Apply the publication figure style the reference loads at import
    time (reference figure_utils.py:17-29 + its bundled matplotlibrc):
    9 pt sans-serif text, frameless legends, open top/right spines,
    inward thin ticks, and — when a TeX toolchain is actually present —
    LaTeX text rendering with bold-vector macros.

    Differences by design: applied on CALL, not import (importing a
    plotting helper must not restyle the process), and ``usetex`` is
    auto-detected (``None``) because most deploy images carry no TeX;
    the reference unconditionally enables it and crashes without LaTeX.
    The style values are set directly as rcParams instead of shipping an
    rc file (the reference's rc is third-party GPL-licensed code).
    """
    import shutil

    import matplotlib as mpl

    thin = 0.566  # the reference style's hairline weight (0.8 * 1/sqrt(2))
    mpl.rcParams.update({
        "font.family": "sans-serif",
        "font.size": 9.0,
        "legend.fontsize": 9.0,
        "legend.frameon": False,
        "axes.labelsize": 9.0,
        "axes.titlesize": 9.0,
        "axes.titleweight": "bold",
        "axes.xmargin": 0.05,
        "axes.ymargin": 0.05,
        "axes.linewidth": thin,
        "axes.spines.top": False,
        "axes.spines.right": False,
        "xtick.labelsize": 9.0,
        "ytick.labelsize": 9.0,
        "xtick.direction": "in",
        "ytick.direction": "in",
        "xtick.major.width": thin,
        "ytick.major.width": thin,
        "lines.linewidth": 1.0,
    })
    if usetex is None:
        usetex = shutil.which("latex") is not None
    if usetex:
        mpl.rcParams["text.usetex"] = True
        mpl.rcParams["text.latex.preamble"] = "\n".join([
            r"\usepackage{amssymb}",
            r"\renewcommand*\familydefault{\sfdefault}",
            r"\renewcommand{\vec}[1]{\mathbf{#1}}",
            r"\newcommand{\mat}[1]{\mathbf{#1}}",
        ])
    return usetex


def circles(x, y, s, c="b", vmin=None, vmax=None, ax=None, **kwargs):
    """Scatter of true-radius circles (data units), like the reference's
    ``circles`` helper (figure_utils.py:44-77)."""
    import matplotlib.pyplot as plt
    from matplotlib.collections import PatchCollection
    from matplotlib.patches import Circle

    if ax is None:
        ax = plt.gca()
    if np.isscalar(c):
        kwargs.setdefault("color", c)
        c = None
    zipped = np.broadcast(x, y, s)
    patches = [Circle((x_, y_), s_) for x_, y_, s_ in zipped]
    collection = PatchCollection(patches, **kwargs)
    if c is not None:
        collection.set_array(np.asarray(c))
        collection.set_clim(vmin, vmax)
    ax.add_collection(collection)
    ax.autoscale_view()
    return collection


def save(fig, filename, fig_width=None, fig_height=None, dpi=300, **kwargs):
    """Save a figure; PDF outputs are crop/compressed through Ghostscript
    when available, otherwise saved directly with tight bounding box."""
    if fig_width is not None:
        h = fig_height or fig_width / 1.618
        fig.set_size_inches(fig_width, h)
    base, ext = os.path.splitext(filename)
    fig.savefig(filename, dpi=dpi, bbox_inches="tight", **kwargs)
    if ext.lower() == ".pdf":
        try:
            tmp = base + "_crop.pdf"
            subprocess.run(
                ["gs", "-sDEVICE=pdfwrite", "-dCompatibilityLevel=1.4",
                 "-dPDFSETTINGS=/ebook", "-dNOPAUSE", "-dQUIET", "-dBATCH",
                 f"-sOutputFile={tmp}", filename],
                check=True, capture_output=True)
            os.replace(tmp, filename)
        except (OSError, subprocess.CalledProcessError):
            pass  # ghostscript unavailable; keep the direct save
    return filename
