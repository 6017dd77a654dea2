"""SSP spaces and VSA matrices: the torch port against the JAX package.

Phase matrices and the fixed DFT / Fourier-layout matrices come from the
same NumPy code and seeds, so they must be bitwise equal; tensor encodes
agree to float32 rounding (1e-5); from-set decodes return the same points.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sspslam_tpu import HexagonalSSPSpace as JaxHexagonalSSPSpace
from sspslam_tpu.ops import vsa as jax_vsa

from sspslam_tpu_torch import HexagonalSSPSpace
from sspslam_tpu_torch.ops import vsa

ENCODE_TOL = 1e-5   # float32 phases + DFT matmul, summed in another order

SPACES = [  # (domain_dim, ssp_dim, seed, length_scale)
    (2, 31, 0, 0.3),
    (2, 97, 0, 0.3),
    (2, 55, 7, 1.0),
    (1, 25, 3, 0.5),
    (3, 49, 1, 0.4),
]


def _pair(domain_dim, ssp_dim, seed, ls):
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (domain_dim, 1))
    kw = dict(ssp_dim=ssp_dim, seed=seed, length_scale=ls,
              domain_bounds=bounds)
    return (JaxHexagonalSSPSpace(domain_dim, **kw),
            HexagonalSSPSpace(domain_dim, **kw))


@pytest.mark.parametrize("cfg", SPACES)
def test_phase_matrix_bitwise(cfg):
    js, ts = _pair(*cfg)
    assert ts.ssp_dim == js.ssp_dim
    assert np.array_equal(ts.phase_matrix, js.phase_matrix)
    assert np.array_equal(ts.length_scale, js.length_scale)


@pytest.mark.parametrize("d", [25, 31, 96, 97])
def test_dft_matrices_bitwise(d):
    for j, t in zip(jax_vsa._rdft_mats(d), vsa._rdft_mats(d, "cpu")):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert np.array_equal(vsa.to_fourier_matrix(d),
                          jax_vsa.to_fourier_matrix(d))
    assert np.array_equal(vsa.from_fourier_matrix(d),
                          jax_vsa.from_fourier_matrix(d))
    K = np.random.default_rng(d).normal(size=(d // 2, 2))
    assert np.array_equal(vsa.conjsym(K), jax_vsa.conjsym(K))


@pytest.mark.parametrize("cfg", SPACES)
def test_encode(cfg):
    js, ts = _pair(*cfg)
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, size=(64, js.domain_dim)).astype(np.float32)
    # host encode: same NumPy code
    assert np.array_equal(ts.encode(x), js.encode(x))
    ls = js.length_scale.ravel()
    ref = np.asarray(jax_vsa.encode(jnp.asarray(js.phase_matrix),
                                    jnp.asarray(x), jnp.asarray(ls)))
    got = vsa.encode(ts.phase_matrix, torch.tensor(x), ls).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ENCODE_TOL)
    # and both agree with the float64 host encode
    np.testing.assert_allclose(got, ts.encode(x), rtol=0, atol=ENCODE_TOL)


@pytest.mark.parametrize("d", [31, 97])
def test_rfft_pair_roundtrip(d):
    v = np.random.default_rng(d).normal(size=(5, d)).astype(np.float32)
    jre, jim = jax_vsa.rfft_pair(jnp.asarray(v))
    tre, tim = vsa.rfft_pair(torch.tensor(v))
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=ENCODE_TOL)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=ENCODE_TOL)
    back = vsa.irfft_pair(tre, tim, d).numpy()
    np.testing.assert_allclose(back, v, atol=ENCODE_TOL)


@pytest.mark.parametrize("cfg", SPACES[:3])
def test_decode_from_set_same_points(cfg):
    js, ts = _pair(*cfg)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, size=(20, js.domain_dim))
    ssps = js.encode(x) + 0.05 * rng.normal(size=(20, js.ssp_dim))
    jp = js.decode(ssps, method="from-set", num_samples=40)
    tp = ts.decode(ssps, method="from-set", num_samples=40, device="cpu")
    assert tp.shape == jp.shape == (20, js.domain_dim)
    assert np.array_equal(tp, jp)
    # most decoded grid points are near the encoded ones (a noisy SSP of a
    # small space can alias to a far grid point, in both packages alike)
    assert np.median(np.abs(tp - x)) < 2.2 / 39


def test_sample_bank_bitwise():
    js, ts = _pair(*SPACES[0])
    for method, n in (("grid", 30), ("Rd", 50), ("length-scale", 10)):
        jss, jpts = js.get_sample_pts_and_ssps(n, method=method)
        tss, tpts = ts.get_sample_pts_and_ssps(n, method=method)
        assert np.array_equal(tpts, jpts)
        assert np.array_equal(tss, jss)


def test_decode_other_methods_not_ported():
    _, ts = _pair(*SPACES[0])
    with pytest.raises(NotImplementedError):
        ts.decode(np.zeros((1, ts.ssp_dim)), method="direct-optim",
                  device="cpu")


def test_decode_and_dft_matrices_need_a_device():
    """Nothing in the port picks a device by itself: the caller names it."""
    _, ts = _pair(*SPACES[0])
    with pytest.raises(TypeError, match="device"):
        ts.decode(np.zeros((1, ts.ssp_dim)), num_samples=10)
    with pytest.raises(TypeError, match="device"):
        vsa._rdft_mats(31)
