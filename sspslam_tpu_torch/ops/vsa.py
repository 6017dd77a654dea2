"""Vector-symbolic-algebra primitives on torch tensors.

Port of :mod:`sspslam_tpu.ops.vsa`, every public name: the real
half-spectrum DFT matrices, SSP encoding (with its Fourier form and its
Jacobian), the binding algebra (bind, unbind, invert, normalize,
make_unitary, the identity), the clean-up against a sample bank, the
conjugate-symmetric phase expansion and axis construction, the sub-SSP
selectors, the neural circular convolution's transforms and the SSP <->
VCO-triple Fourier layouts.  The DFT stays a matmul, as in the JAX
package, so both packages hold the same float32 matrices bitwise;
``torch.fft`` is a later measurement, not a given.  The host NumPy
helpers (phase expansion, axes, sub-SSP selectors, binding transforms)
are copies of the JAX package's.

Conventions are those of the JAX module: ``phase_matrix`` is a
(ssp_dim, domain_dim) conjugate-symmetric matrix, and every function treats
the LAST axis as the vector axis and broadcasts over leading axes.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

__all__ = ["encode", "encode_fourier", "encode_and_deriv", "rfft_pair",
           "irfft_pair", "bind", "unbind", "invert", "normalize",
           "make_unitary", "make_unitary_fourier", "identity_vector",
           "similarity", "default_cleanup_dtype", "nearest_row",
           "cleanup_from_set", "conjsym", "construct_axes_from_phases",
           "dft_half_matrices", "binding_input_transforms",
           "binding_output_transform", "to_fourier_matrix",
           "from_fourier_matrix", "sub_fourier_extract", "sub_ssp_extract",
           "sub_fourier_project", "sub_ssp_project"]


@lru_cache(maxsize=64)
def _rdft_mats_np(d: int):
    h = d // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(h), np.arange(d)) / d
    W_re = np.cos(ang)
    W_im = -np.sin(ang)
    coef = np.full(h, 2.0)
    coef[0] = 1.0
    if d % 2 == 0:
        coef[-1] = 1.0
    M_c = (coef[None, :] * np.cos(ang).T) / d
    M_s = -(coef[None, :] * np.sin(ang).T) / d
    return W_re, W_im, M_c, M_s


@lru_cache(maxsize=64)
def _rdft_mats_on(d: int, device: torch.device, dtype):
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in _rdft_mats_np(d))


def _rdft_mats(d: int, device, dtype=torch.float32):
    """(W_re, W_im, M_c, M_s) as tensors on ``device``:
    forward:  Z_j = (W_re @ x)_j + i (W_im @ x)_j   for j in [0, d//2]
    inverse:  x = M_c @ Re(Z) + M_s @ Im(Z)          (conj-symmetric Z)

    Uploaded once per (d, device, dtype) and shared by every caller after
    that, so a step that binds (the auto-recovery gate's anchor channels)
    uploads nothing and can be captured as a CUDA graph.  Read-only.
    """
    return _rdft_mats_on(d, torch.device(device), dtype)


@lru_cache(maxsize=64)
def _invert_index(d: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor((-np.arange(d)) % d, device=device)


def rfft_pair(v: torch.Tensor):
    """(Re, Im) of the half-spectrum DFT of a real vector, shapes (..., h)."""
    W_re, W_im, _, _ = _rdft_mats(v.shape[-1], v.device, v.dtype)
    return (torch.einsum("hd,...d->...h", W_re, v),
            torch.einsum("hd,...d->...h", W_im, v))


def irfft_pair(re: torch.Tensor, im: torch.Tensor, d: int) -> torch.Tensor:
    """Real inverse DFT from half-spectrum (Re, Im) parts."""
    _, _, M_c, M_s = _rdft_mats(d, re.device, re.dtype)
    return (torch.einsum("dh,...h->...d", M_c, re)
            + torch.einsum("dh,...h->...d", M_s, im))


def _on(a, x: torch.Tensor) -> torch.Tensor:
    """``a`` (a NumPy array, a scalar or a tensor) as a tensor of ``x``'s
    dtype on ``x``'s device; a tensor already there is not copied, so a
    step that passes its hoisted tables uploads nothing."""
    if torch.is_tensor(a):
        return a.to(device=x.device, dtype=x.dtype)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=x.dtype,
                           device=x.device)


def _phase_and_scale(phase_matrix, x, length_scale):
    A = _on(phase_matrix, x)
    ls = torch.broadcast_to(_on(length_scale, x).reshape(-1), x.shape[-1:])
    return A, ls


def encode(phase_matrix, x: torch.Tensor, length_scale) -> torch.Tensor:
    """SSP encoding ``IDFT(exp(i A x / l))`` of points ``x`` (..., n) in
    real arithmetic: cos/sin of the half-spectrum phases, then the
    inverse-DFT matmul.  Returns (..., d) on ``x``'s device and dtype.
    ``phase_matrix`` and ``length_scale`` may be host arrays or tensors
    on ``x``'s device (a step passes tensors)."""
    A, ls = _phase_and_scale(phase_matrix, x, length_scale)
    d = A.shape[0]
    phases = torch.einsum("hn,...n->...h", A[:d // 2 + 1], x / ls)
    return irfft_pair(torch.cos(phases), torch.sin(phases), d)


def encode_fourier(phase_matrix, x: torch.Tensor, length_scale):
    """(Re, Im) of the full Fourier coefficients exp(i A x / l), (..., d)."""
    A, ls = _phase_and_scale(phase_matrix, x, length_scale)
    phases = torch.einsum("dn,...n->...d", A, x / ls)
    return torch.cos(phases), torch.sin(phases)


def encode_and_deriv(phase_matrix, x: torch.Tensor, length_scale):
    """SSP encoding and its Jacobian d phi / d x: ((..., d), (..., d, n))."""
    A, ls = _phase_and_scale(phase_matrix, x, length_scale)
    d = A.shape[0]
    h = d // 2 + 1
    A_ls = A / ls[None, :]
    phases = torch.einsum("hn,...n->...h", A_ls[:h], x)
    c, s = torch.cos(phases), torch.sin(phases)
    phi = irfft_pair(c, s, d)
    # d z/dx_j = i A_j z  ->  Re' = -sin * A_j, Im' = cos * A_j
    dre = -s[..., :, None] * A_ls[:h]                     # (..., h, n)
    dim = c[..., :, None] * A_ls[:h]
    _, _, M_c, M_s = _rdft_mats(d, x.device, x.dtype)
    dphi = (torch.einsum("dh,...hn->...dn", M_c, dre)
            + torch.einsum("dh,...hn->...dn", M_s, dim))
    return phi, dphi


# ---------------------------------------------------------------------------
# Binding algebra (circular convolution)
# ---------------------------------------------------------------------------

def bind(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular convolution a * b along the last axis, as real
    half-spectrum matmuls."""
    d = a.shape[-1]
    ar, ai = rfft_pair(a)
    br, bi = rfft_pair(b)
    return irfft_pair(ar * br - ai * bi, ar * bi + ai * br, d)


def unbind(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular correlation: bind with the involution of ``a`` (conj in
    Fourier)."""
    d = a.shape[-1]
    ar, ai = rfft_pair(a)
    br, bi = rfft_pair(b)
    return irfft_pair(ar * br + ai * bi, ar * bi - ai * br, d)


def invert(a: torch.Tensor) -> torch.Tensor:
    """Involution a[-i mod d]: the binding inverse for unitary vectors."""
    return a[..., _invert_index(a.shape[-1], a.device)]


def normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale to unit L2 norm (safe at 0)."""
    nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp_min(nrm, eps)


def make_unitary(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Project all Fourier coefficients onto the unit circle."""
    d = v.shape[-1]
    re, im = rfft_pair(v)
    mag = torch.clamp_min(torch.sqrt(re * re + im * im), eps)
    return irfft_pair(re / mag, im / mag, d)


def make_unitary_fourier(fv, eps: float = 1e-8):
    """Normalise (Re, Im) half-spectrum pairs onto the unit circle."""
    re, im = fv
    mag = torch.clamp_min(torch.sqrt(re * re + im * im), eps)
    return re / mag, im / mag


def identity_vector(d: int, dtype=torch.float32, *, device) -> torch.Tensor:
    """Binding identity: delta at index 0, on ``device``."""
    v = torch.zeros((d,), dtype=dtype, device=device)
    v[0] = 1.0
    return v


def similarity(vectors: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dot products of ``v`` (..., d) against a codebook (m, d) -> (..., m)."""
    return torch.einsum("md,...d->...m", vectors, v)


def default_cleanup_dtype():
    """The dtype of the clean-up similarity product in the models:
    bfloat16, unless SSPSLAM_CLEANUP_F32=1 asks for full precision (the
    JAX package's switch).  :func:`cleanup_from_set` itself defaults to
    float32."""
    return (torch.float32 if os.environ.get("SSPSLAM_CLEANUP_F32")
            else torch.bfloat16)


#: (first global row, shard handle) while a sharded step runs a node
#: function that holds rows of its sample bank (set by the executor)
_ROW_SHARD = None


def set_row_shard(rows) -> None:
    """Mark the banks :func:`nearest_row` is given as rows of a bank split
    over a model axis: ``(first global row, shard handle)``, or None."""
    global _ROW_SHARD
    _ROW_SHARD = rows


def nearest_row(bank: torch.Tensor, bank_sim: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """The row of ``bank`` (m, d) whose row of ``bank_sim`` (the same bank,
    in the dtype of the similarity product) is most similar to ``v``
    (..., d): the argmax (the first maximal index, as ``jnp.argmax``) and
    a gather, with no host read, so a captured step can run it.

    Under a sharded step (:func:`set_row_shard`) the banks are this rank's
    rows of the whole bank, and the pick keeps ``jnp.argmax``'s
    first-occurrence rule across ranks: the local maximum and its first
    index, a MAX all-reduce of the value, a MIN all-reduce of the global
    index over the ranks that hold the maximum, then the picked row summed
    from the rank that holds it (zeros elsewhere)."""
    sims = similarity(bank_sim, v.to(bank_sim.dtype))
    best = torch.argmax(sims, dim=-1)
    if _ROW_SHARD is None:
        return bank.index_select(0, best.reshape(-1)).reshape(v.shape)
    first, shard = _ROW_SHARD
    m = bank.shape[0]
    val = sims.gather(-1, best.unsqueeze(-1)).squeeze(-1).float()
    top = shard.all_reduce(val.clone(), "max")
    big = torch.full_like(best, m * shard.world)
    pick = shard.all_reduce(torch.where(val == top, best + first, big),
                            "min")
    local = pick - first
    mine = (local >= 0) & (local < m)
    row = bank.index_select(0, local.clamp(0, m - 1).reshape(-1)).reshape(
        v.shape).float()
    row = row * mine.unsqueeze(-1).to(row.dtype)
    return shard.all_reduce(row, "sum").to(bank.dtype)


def cleanup_from_set(sample_ssps: torch.Tensor, v: torch.Tensor,
                     sim_dtype=torch.float32) -> torch.Tensor:
    """Replace ``v`` (..., d) with the most similar row of ``sample_ssps``
    (m, d), gathered from the bank as given.

    ``sim_dtype`` is the dtype of the similarity product (float32 by
    default; bfloat16 halves the bank read and only risks a tie flipping
    the pick to a neighbouring sample); ``None`` compares in the bank's
    dtype."""
    return nearest_row(sample_ssps, sample_ssps if sim_dtype is None
                       else sample_ssps.to(sim_dtype), v)


def conjsym(K: np.ndarray) -> np.ndarray:
    """Expand (m, n) free phases into a (2m+1, n) conjugate-symmetric phase
    matrix: row 0 zero, rows 1..m = K, rows m+1..2m = -flip(K)."""
    K = np.atleast_2d(np.asarray(K, dtype=np.float64))
    m, n = K.shape
    F = np.zeros((2 * m + 1, n))
    F[1 : m + 1] = K
    F[m + 1 :] = -np.flip(K, axis=0)
    return F


def construct_axes_from_phases(K: np.ndarray, even: bool = False) -> np.ndarray:
    """Build unit-magnitude axis vectors from an (m, n) free-phase matrix:
    each column's conjugate-symmetric spectrum exp(i*phases) is inverse-
    transformed to a real (2m+1[+1], n) axis bank."""
    K = np.atleast_2d(np.asarray(K, dtype=np.float64))
    m, n = K.shape
    d = 2 * m + 1 + (1 if even else 0)
    F = np.ones((d, n), dtype=complex)
    F[1:m + 1] = np.exp(1j * K)
    F[d - m:] = np.conj(np.exp(1j * K))[::-1]
    return np.fft.ifft(F, axis=0).real


# ---------------------------------------------------------------------------
# Sub-SSP (multi-scale module) extraction / projection matrices
# ---------------------------------------------------------------------------
# A multi-scale SSP S_total of dim 2*sublen*N + 1 decomposes into N sub-SSPs,
# each owning ``sublen`` consecutive positive frequencies (plus the shared DC
# term and the conjugate-symmetric mirror).  These matrices pick out /
# reassemble sub-vectors in the Fourier or time domain.

def _sub_freq_selector(n: int, N: int, sublen: int, dc_scale: float):
    """(2*sublen+1, tot) complex-frequency selection: rows pick module n's
    positive freqs, the DC term (scaled), and the mirrored negative freqs."""
    tot = 2 * sublen * N + 1
    sel = np.zeros((2 * sublen + 1, tot))
    pos = np.arange(sublen * n, sublen * (n + 1))
    sel[np.arange(sublen), pos] = 1.0
    sel[sublen, sublen * N] = dc_scale
    neg = tot - np.arange(sublen * (n + 1), sublen * n, -1)
    sel[np.arange(sublen + 1, 2 * sublen + 1), neg] = 1.0
    return sel


def sub_fourier_extract(n: int, N: int, sublen: int = 3) -> np.ndarray:
    """A-bar_n: F{S_n} = A-bar_n @ F{S_total} (frequency-domain pick-out)."""
    return _sub_freq_selector(n, N, sublen, dc_scale=1.0)


def sub_ssp_extract(n: int, N: int, sublen: int = 3) -> np.ndarray:
    """A_n: S_n = A_n @ S_total (time-domain pick-out), derived as
    IDFT_small . ifftshift(A-bar_n) . DFT_big."""
    tot = 2 * sublen * N + 1
    FA = np.fft.ifftshift(sub_fourier_extract(n, N, sublen))
    W = np.fft.fft(np.eye(tot))
    invW = np.fft.ifft(np.eye(2 * sublen + 1))
    return np.real(invW @ FA @ W)


def sub_fourier_project(n: int, N: int, sublen: int = 3) -> np.ndarray:
    """B-bar_n: sum_n B-bar_n @ F{S_n} = F{S_total}. The DC row is scaled by
    1/N so the N sub-vectors' unit DC terms sum back to 1."""
    return _sub_freq_selector(n, N, sublen, dc_scale=1.0 / N).T


def sub_ssp_project(n: int, N: int, sublen: int = 3) -> np.ndarray:
    """B_n: sum_n B_n @ S_n = S_total (time-domain projection)."""
    tot = 2 * sublen * N + 1
    FB = np.fft.ifftshift(sub_fourier_project(n, N, sublen))
    invW = np.fft.ifft(np.eye(tot))
    W = np.fft.fft(np.eye(2 * sublen + 1))
    return np.real(invW @ FB @ W)


# ---------------------------------------------------------------------------
# Fixed linear transforms for the *neural* binding network
# ---------------------------------------------------------------------------
# The neural CircularConvolution computes DFT(a)*DFT(b) with four real
# product channels per retained frequency (Gosmann alignment):
#   channels per freq i: w=ReF*ReG, x=ImF*ImG, y=ReF*ImG, z=ImF*ReG
#   Re H[i] = w - x ; Im H[i] = y + z
# Input transform A rows per freq: [ReF, ImF, ReF, ImF]
# Input transform B rows per freq: [ReG, ImG, ImG, ReG]
# Output transform folds (w,x,y,z) -> real IDFT.

def dft_half_matrices(d: int):
    """Real/imag parts of the half-spectrum DFT matrix, shape (d//2+1, d)."""
    x = np.arange(d)
    w = np.arange(d // 2 + 1)
    M = np.exp((-2.0j * np.pi / d) * np.outer(w, x))
    return M.real, M.imag


def binding_input_transforms(d: int, invert_a: bool = False,
                             invert_b: bool = False):
    """(tr_a, tr_b), each (4*(d//2+1), d): map inputs into aligned
    half-spectrum product channels. ``invert_*`` conjugates that operand
    (circular correlation)."""
    re, im = dft_half_matrices(d)
    im_a = -im if invert_a else im
    im_b = -im if invert_b else im
    h = d // 2 + 1
    tr_a = np.zeros((4 * h, d))
    tr_b = np.zeros((4 * h, d))
    tr_a[0::4] = re
    tr_a[1::4] = im_a
    tr_a[2::4] = re
    tr_a[3::4] = im_a
    tr_b[0::4] = re
    tr_b[1::4] = im_b
    tr_b[2::4] = im_b
    tr_b[3::4] = re
    return tr_a, tr_b


def binding_output_transform(d: int) -> np.ndarray:
    """(d, 4*(d//2+1)) matrix folding product channels through the inverse
    DFT: out = (1/d) * sum_i c_i * (ReW_i*ReH_i - ImW_i*ImH_i), where W is
    the half DFT and c_i = 1 for i == 0 (and i == d/2 for even d), else 2."""
    re, im = dft_half_matrices(d)
    h = d // 2 + 1
    coef = np.full(h, 2.0)
    coef[0] = 1.0
    if d % 2 == 0:
        coef[-1] = 1.0
    out = np.zeros((d, 4 * h))
    out[:, 0::4] = (coef * re.T) / d          # w  (Re channel, +)
    out[:, 1::4] = -(coef * re.T) / d         # x  (Re channel, -)
    out[:, 2::4] = (coef * im.T) / d          # y  (Im channel)
    out[:, 3::4] = (coef * im.T) / d          # z
    return out


# The path integrator represents the SSP in the Fourier domain as
# k = (d+1)//2 triples [Re F_j, Im F_j, omega_j] (one per VCO).

def to_fourier_matrix(d: int) -> np.ndarray:
    """(3k, d) matrix: SSP -> [Re F_1..k-1, Im F_1..k-1] in VCO triple layout.

    VCO j (j>=1) rows 3j, 3j+1 get Re/Im of DFT row j; VCO 0 (the DC term)
    rows are zero — it is pinned to [1, 0, 0] by a constant input instead.
    Frequency rows (3j+2) are zero: omega comes from the velocity input.
    """
    k = (d + 1) // 2
    W = np.fft.fft(np.eye(d))
    M = np.zeros((3 * k, d))
    M[3::3] = W[1:k].real
    M[4::3] = W[1:k].imag
    return M


def from_fourier_matrix(d: int) -> np.ndarray:
    """(d, 3k) matrix: stacked VCO triples -> SSP.

    Reconstructs x = Re(IFFT(F)) with F_0 taken from VCO 0's Re component,
    F_j from VCO j, and the upper half of the spectrum by conjugate symmetry.
    For even d the Nyquist row F_{d/2} is not represented by any VCO and is
    dropped.
    """
    k = (d + 1) // 2
    invW = np.fft.ifft(np.eye(d))  # (d, d) complex, x = invW @ F
    M = np.zeros((d, 3 * k))
    for j in range(k):
        # F_j = Re + i Im ; F_{d-j} = Re - i Im (conjugate symmetry), j>0
        col_re = invW[:, j].copy()
        col_im = 1j * invW[:, j]
        if j > 0 and (d - j) != j:
            col_re = col_re + invW[:, d - j]
            col_im = col_im - 1j * invW[:, d - j]
        M[:, 3 * j] = col_re.real
        M[:, 3 * j + 1] = col_im.real
    return M
