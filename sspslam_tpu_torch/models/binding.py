"""Neural binding networks: element-wise Product and CircularConvolution.

A copy of :mod:`sspslam_tpu.models.binding` over the port's graph (the
network description is NumPy): the DFT alignment/product/IDFT
decomposition of the reference's binding.py, with the transforms from
:mod:`sspslam_tpu_torch.ops.vsa` and the per-dimension squaring populations
as ONE batched EnsembleArray — the whole binding network is two batched
matmuls around a fused square.
"""

from __future__ import annotations

import numpy as np

from ..nef import Connection, EnsembleArray, Network, Node
from ..ops import vsa

__all__ = ["circconv", "Product", "CircularConvolution",
           "dot_product_transform"]


def circconv(a, b, invert_a=False, invert_b=False, axis=-1):
    """NumPy reference circular convolution (test oracle; same contract as
    reference binding.py:12-20)."""
    A = np.fft.fft(a, axis=axis)
    B = np.fft.fft(b, axis=axis)
    if invert_a:
        A = A.conj()
    if invert_b:
        B = B.conj()
    return np.fft.ifft(A * B, axis=axis).real


def dot_product_transform(dimensions, scale=1.0):
    """(1, dimensions) summing transform."""
    return scale * np.ones((1, dimensions))


class Product(Network):
    """Element-wise product via the Gosmann decomposition:
    x*y = ((x+y)^2 - (x-y)^2) / 4 (reference binding.py:233-324).

    Both squared terms live in ONE batched EnsembleArray of 2*dimensions
    1-D populations (rows [0, d) hold (x+y)/sqrt(2), rows [d, 2d) hold
    (x-y)/sqrt(2)) — half the ensemble groups and matmuls per step compared
    to separate sq1/sq2 arrays, with identical math.  ``sq1``/``sq2`` remain
    available as element views for API parity."""

    def __init__(self, n_neurons, dimensions, input_magnitude=1.0,
                 dot_product=False, label="product", **kwargs):
        super().__init__(label=label)
        self.dimensions = dimensions
        radius = input_magnitude * np.sqrt(2)
        with self:
            self.input_a = Node(size_in=dimensions, label=f"{label}_input_a")
            self.input_b = Node(size_in=dimensions, label=f"{label}_input_b")
            out_dim = 1 if dot_product else dimensions
            self.output = Node(size_in=out_dim, label=f"{label}_output")

            self.sq = EnsembleArray(max(1, n_neurons // 2), 2 * dimensions,
                                    ens_dimensions=1, radius=radius,
                                    label=f"{label}_sq", **kwargs)

            tr = 1.0 / np.sqrt(2.0)
            eye = np.eye(dimensions)
            # rows [0, d): (a + b)/sqrt(2); rows [d, 2d): (a - b)/sqrt(2)
            Connection(self.input_a, self.sq.input,
                       transform=tr * np.vstack([eye, eye]), synapse=None)
            Connection(self.input_b, self.sq.input,
                       transform=tr * np.vstack([eye, -eye]), synapse=None)

            sq_out = self.sq.add_output("square", np.square)

            if dot_product:
                tr_out = np.hstack([dot_product_transform(dimensions, 0.5),
                                    dot_product_transform(dimensions, -0.5)])
            else:
                tr_out = np.hstack([0.5 * eye, -0.5 * eye])
            Connection(sq_out, self.output, transform=tr_out, synapse=None)

        # element views over the two halves, for parity with the reference's
        # sq1/sq2 attributes
        self.sq1 = self.sq.ea_ensembles[:dimensions]
        self.sq2 = self.sq.ea_ensembles[dimensions:]


class CircularConvolution(Network):
    """Neural circular convolution c = IDFT(DFT(a) * DFT(b)).

    ``invert_a`` / ``invert_b`` conjugate the corresponding operand
    (circular correlation — unbinding).  Four aligned real product channels
    per retained frequency; see :func:`sspslam_tpu_torch.ops.vsa.
    binding_input_transforms` for the construction (reference
    binding.py:92-218)."""

    def __init__(self, n_neurons, dimensions, invert_a=False, invert_b=False,
                 input_magnitude=1.0, label="circonv", **kwargs):
        super().__init__(label=label)
        self.dimensions = dimensions

        tr_a, tr_b = vsa.binding_input_transforms(dimensions, invert_a, invert_b)
        tr_out = vsa.binding_output_transform(dimensions)

        with self:
            self.input_a = Node(size_in=dimensions, label=f"{label}_input_a")
            self.input_b = Node(size_in=dimensions, label=f"{label}_input_b")
            self.product = Product(n_neurons, tr_a.shape[0],
                                   input_magnitude=input_magnitude * 2,
                                   label=f"{label}_product")
            self.output = Node(size_in=dimensions, label=f"{label}_output")

            Connection(self.input_a, self.product.input_a, transform=tr_a,
                       synapse=None)
            Connection(self.input_b, self.product.input_b, transform=tr_b,
                       synapse=None)
            Connection(self.product.output, self.output, transform=tr_out,
                       synapse=None)

    @property
    def A(self):  # pragma: no cover - legacy alias
        return self.input_a

    @property
    def B(self):  # pragma: no cover - legacy alias
        return self.input_b
