"""The rest of the L0 algebra on the CPU against the JAX package: the vsa
additions and the sub-SSP selectors, the host methods of SSPSpace, the
Newton polish and the three decode methods it and the MLP decoder give,
the decoder's training, its npz file read by both packages, and the
reference Keras decoder's loading.

Tolerances:
- host NumPy code (the selectors, the space's host methods): 1e-12, and
  bitwise where the two packages run the same NumPy calls on the same
  random stream;
- tensor encodes (float32): 1e-5;
- the Newton polish, per row and through ``decode("direct-optim")`` /
  ``"network-optim"``: 1e-4.  Its maximiser is fixed only to the float32
  resolution of the objective (a sum of d cosines): points a few 1e-5
  apart are equal maxima to the last bit, so the candidates' argmin may
  pick either, and the JAX package's own jitted and eager calls differ by
  up to 2e-4 on noisy inputs.  The inputs are SSPs with noise 0.05 at the
  widths the decoder serves, where both packages land within 1e-4;
- the MLP decode with the JAX parameters carried across: 1e-5;
- the decoder's training from the same start (4,096 points, batch 512, two
  epochs, 16 Adam steps): parameters within 1e-4 and the epochs' mean
  losses within 1e-5 relative (the two packages round Adam's update and
  the loss's reductions in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sspslam_tpu as jsp
from sspslam_tpu import sspspace as jss
from sspslam_tpu.ops import vsa as jvsa

import sspslam_tpu_torch as psp
from sspslam_tpu_torch import sspspace as pss
from sspslam_tpu_torch.ops import vsa as pvsa

HOST_TOL = 1e-12
F32_TOL = 1e-5
NEWTON_TOL = 1e-4
MLP_TOL = 1e-5
TRAIN_PARAM_TOL = 1e-4
TRAIN_LOSS_RTOL = 1e-5
# (domain_dim, ssp_dim): the 1-, 2- and 3-D Newton solves (n = 1, 2, 3)
NEWTON_SPACES = [(1, 17), (2, 97), (3, 73)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(domain_dim=2, ssp_dim=97, ls=0.3, bounded=True, seed=0):
    bounds = (1.1 * np.tile(np.array([-1, 1.0]), (domain_dim, 1))
              if bounded else None)
    kw = dict(ssp_dim=ssp_dim, seed=seed, length_scale=ls,
              domain_bounds=bounds)
    return (jsp.HexagonalSSPSpace(domain_dim, **kw),
            psp.HexagonalSSPSpace(domain_dim, **kw))


def _noisy_ssps(space, n, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = -0.9, 0.9
    x = rng.uniform(lo, hi, (n, space.domain_dim))
    return x, space.encode(x) + noise * rng.normal(size=(n, space.ssp_dim))


# ---------------------------------------------------------------------------
# (1) the vsa additions
# ---------------------------------------------------------------------------

HOST_FUNCS = [
    ("construct_axes_from_phases", (np.linspace(0, 3, 12).reshape(6, 2),)),
    ("construct_axes_from_phases", (np.linspace(0, 3, 12).reshape(4, 3),
                                    True)),
    ("sub_fourier_extract", (1, 4, 3)),
    ("sub_ssp_extract", (2, 4, 3)),
    ("sub_fourier_project", (0, 5, 2)),
    ("sub_ssp_project", (3, 4, 3)),
]


@pytest.mark.parametrize("name,args", HOST_FUNCS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(HOST_FUNCS)])
def test_host_helpers_match_jax(name, args):
    want = getattr(jvsa, name)(*args)
    got = getattr(pvsa, name)(*args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=HOST_TOL)


def test_sub_ssp_extract_project_roundtrip():
    """tests/test_subssp.py's oracle on the port's selectors: sum_n B_n
    A_n S == S, and the time-domain pick-out equals the frequency one."""
    N, sublen = 4, 3
    S = np.random.default_rng(0).normal(size=2 * sublen * N + 1)
    acc = sum(pvsa.sub_ssp_project(n, N, sublen)
              @ (pvsa.sub_ssp_extract(n, N, sublen) @ S) for n in range(N))
    np.testing.assert_allclose(acc, S, atol=1e-10)
    FA = pvsa.sub_fourier_extract(1, N, sublen)
    want = np.fft.ifft(np.fft.ifftshift(
        FA @ np.fft.fftshift(np.fft.fft(S)))).real
    np.testing.assert_allclose(pvsa.sub_ssp_extract(1, N, sublen) @ S,
                               want, atol=1e-9)
    assert pss._get_sub_SSP is pvsa.sub_ssp_extract
    assert pss._proj_sub_FourierSSP is pvsa.sub_fourier_project


@pytest.mark.parametrize("dim,d", [(1, 25), (2, 55), (3, 49)])
def test_tensor_encodes_match_jax(dim, d):
    js, ps = _pair(dim, d)
    x = np.random.default_rng(1).uniform(-1, 1, (7, dim)).astype(np.float32)
    ls = np.float32(0.3)
    jre, jim = jvsa.encode_fourier(js.phase_matrix, jnp.asarray(x), ls)
    pre, pim = pvsa.encode_fourier(ps.phase_matrix, torch.as_tensor(x), ls)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jre), atol=F32_TOL)
    np.testing.assert_allclose(pim.numpy(), np.asarray(jim), atol=F32_TOL)
    jphi, jd = jvsa.encode_and_deriv(js.phase_matrix, jnp.asarray(x), ls)
    pphi, pd = pvsa.encode_and_deriv(ps.phase_matrix, torch.as_tensor(x),
                                     ls)
    assert pd.shape == (7, js.ssp_dim, dim)
    np.testing.assert_allclose(pphi.numpy(), np.asarray(jphi), atol=F32_TOL)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=F32_TOL)
    # the tensor twin of encode takes tensors for its tables too
    np.testing.assert_allclose(
        pvsa.encode(torch.as_tensor(ps.phase_matrix, dtype=torch.float32),
                    torch.as_tensor(x), torch.tensor([0.3])).numpy(),
        np.asarray(jvsa.encode(js.phase_matrix, jnp.asarray(x), ls)),
        atol=F32_TOL)
    fr, fi = pvsa.rfft_pair(pphi)
    jr, ji = jvsa.make_unitary_fourier(jvsa.rfft_pair(jphi))
    ur, ui = pvsa.make_unitary_fourier((fr, fi))
    np.testing.assert_allclose(ur.numpy(), np.asarray(jr), atol=F32_TOL)
    np.testing.assert_allclose(ui.numpy(), np.asarray(ji), atol=F32_TOL)


# ---------------------------------------------------------------------------
# (2) the space's host methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,d", [(2, 31), (3, 49)])
def test_space_encodings_and_fields_match_jax(dim, d):
    js, ps = _pair(dim, d)
    x = np.random.default_rng(2).uniform(-1, 1, (5, dim))
    np.testing.assert_array_equal(ps.encode_fourier(x), js.encode_fourier(x))
    for a, b in zip(ps.encode_and_deriv(x), js.encode_and_deriv(x)):
        np.testing.assert_array_equal(a, b)
    v = js.encode(x[:1])[0]
    for a, b in zip(ps.similarity_grid(v, 9), js.similarity_grid(v, 9)):
        np.testing.assert_allclose(a, b, rtol=0, atol=HOST_TOL)
    np.testing.assert_array_equal(ps.get_sample_ssps(4, method="grid"),
                                  js.get_sample_ssps(4, method="grid"))


def test_host_algebra_matches_jax():
    js, ps = _pair(2, 31)
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 3, 31))
    for name, args in (("normalize", (a[0],)), ("make_unitary", (a,)),
                       ("make_unitary_fourier", (np.fft.fft(a),)),
                       ("identity", ()), ("bind", (a, b)),
                       ("invert", (a,))):
        np.testing.assert_array_equal(getattr(ps, name)(*args),
                                      getattr(js, name)(*args), err_msg=name)


@pytest.mark.parametrize("method,n_neurons", [
    ("sobol", 14), ("sobol", 40), ("grid", 9), ("Rd", 5)],
    ids=["sobol-N", "sobol-more", "grid-fewer", "Rd-fewer"])
def test_sample_wave_encoders_same_seed_bitwise(method, n_neurons):
    """Same seed, same draws: the encoders are bitwise equal (ssp_dim 31
    gives N = 14 single-frequency slots)."""
    js, ps = _pair(2, 31)
    np.testing.assert_array_equal(ps.sample_wave_encoders(n_neurons, method),
                                  js.sample_wave_encoders(n_neurons, method))


def test_lengthscale_update_and_fit_match_jax():
    js, ps = _pair(2, 31, ls=0.5)
    for sp in (js, ps):
        sp.update_lengthscale(0.7)
        assert sp._sample_cache == {}
    np.testing.assert_array_equal(ps.length_scale, js.length_scale)
    for sp in (js, ps):
        sp.update_lengthscale([0.4, 0.6])
    np.testing.assert_array_equal(ps.length_scale, js.length_scale)
    # the fit regresses (d, d) targets on d encoded points: the targets
    # are the points' SSPs at length scales (0.3, 0.45)
    xs = np.random.default_rng(4).uniform(-1, 1, (ps.ssp_dim, 2))
    ys = ps.encode(xs / np.array([0.3, 0.45]) * ps._ls_vec)
    for sp in (js, ps):
        sp.optimize_lengthscale(xs, ys)
    np.testing.assert_allclose(ps.length_scale, js.length_scale,
                               rtol=HOST_TOL, atol=0)


def test_similarity_plot_matches_jax():
    import matplotlib
    matplotlib.use("Agg")
    js, ps = _pair(2, 31)
    v = js.encode([[0.1, 0.2]])[0]
    meshes = [sp.similarity_plot(v, n_grid=8) for sp in (js, ps)]
    np.testing.assert_array_equal(meshes[1].get_array(),
                                  meshes[0].get_array())


# ---------------------------------------------------------------------------
# (3) the Newton polish and decode("direct-optim")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_small_solve_matches_lapack(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(6, n, n)) + 3 * np.eye(n)
    b = rng.normal(size=(6, n))
    got = pss._solve_small(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(A, b[..., None])
                               [..., 0], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dim,d", NEWTON_SPACES)
def test_newton_core_per_row_matches_jax(dim, d):
    """One row at a time, both packages' ``_newton_refine_core`` (JAX's
    called eagerly, as the clean-up node's closure is), 8 iterations from
    the same start."""
    js, ps = _pair(dim, d)
    mat, lo, hi = ps._newton_tables()
    x, phi = _noisy_ssps(js, 4, seed=5)
    u = phi / np.linalg.norm(phi, axis=1, keepdims=True)
    tgt = np.conj(np.fft.fft(u, axis=-1))
    x0 = (x + 0.05).astype(np.float32)
    f = np.float32
    for i in range(len(x)):
        want = jss._newton_refine_core(
            jnp.asarray(mat, f), jnp.asarray(tgt[i].real, f),
            jnp.asarray(tgt[i].imag, f), jnp.asarray(x0[i]),
            (jnp.asarray(lo, f), jnp.asarray(hi, f)), 8)
        got = pss._newton_refine_core(
            torch.as_tensor(mat, dtype=torch.float32),
            torch.as_tensor(tgt[i].real, dtype=torch.float32),
            torch.as_tensor(tgt[i].imag, dtype=torch.float32),
            torch.as_tensor(x0[i]),
            (torch.as_tensor(lo, dtype=torch.float32),
             torch.as_tensor(hi, dtype=torch.float32)), 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=NEWTON_TOL, err_msg=f"row {i}")


@pytest.mark.parametrize("dim,d,bounded", [
    *((dim, d, True) for dim, d in NEWTON_SPACES), (2, 97, False)],
    ids=["1-D", "2-D", "3-D", "2-D-unbounded"])
def test_decode_direct_optim_matches_jax(dim, d, bounded):
    js, ps = _pair(dim, d, bounded=bounded)
    x, phi = _noisy_ssps(js, 64, seed=6)
    # the unbounded box is +-10: sampled as densely as the bounded +-1.1
    ns = {1: 100, 2: 30, 3: 10}[dim] if bounded else 270
    want = js.decode(phi, "direct-optim", num_samples=ns)
    got = ps.decode(phi, "direct-optim", num_samples=ns, device="cpu")
    np.testing.assert_allclose(got, want, atol=NEWTON_TOL)
    if dim == 2 and bounded:
        # tests/test_sspspace.py's oracle: noise-free SSPs decode to 5e-3
        pts = np.random.default_rng(1).uniform(-0.8, 0.8, (10, 2))
        out = ps.decode(ps.encode(pts), "direct-optim", num_samples=30,
                        device="cpu")
        assert np.abs(out - pts).max() < 5e-3


# ---------------------------------------------------------------------------
# (4) the MLP decoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_pair(tmp_path_factory):
    """A JAX-trained decoder (4,096 points, 20 epochs) carried across."""
    js, ps = _pair(2, 55)
    js.train_decoder_net(n_training_pts=4096, n_epochs=20, batch_size=256,
                         load_file=False, save_file=False)
    ps.decoder_params = [np.asarray(p) for p in js.decoder_params]
    return js, ps


def test_decode_network_matches_jax(trained_pair):
    js, ps = trained_pair
    x, phi = _noisy_ssps(js, 64, noise=0.0, seed=7)
    np.testing.assert_allclose(ps.decode(phi, "network", device="cpu"),
                               js.decode(phi, "network"), atol=MLP_TOL)
    np.testing.assert_allclose(ps.decode(phi, "network-optim", device="cpu"),
                               js.decode(phi, "network-optim"),
                               atol=NEWTON_TOL)
    with pytest.raises(RuntimeError, match="train_decoder_net"):
        _pair(2, 55)[1].decode(phi, "network", device="cpu")


def test_train_decoder_net_matches_jax(tmp_path):
    """Same initial draws, same epoch permutations, Adam with optax's
    rule: 16 steps of both packages from the same start."""
    js, ps = _pair(2, 31)
    kw = dict(n_training_pts=4096, batch_size=512, n_epochs=2,
              load_file=False)
    jhist = js.train_decoder_net(folder=str(tmp_path / "jax"), **kw)
    phist = ps.train_decoder_net(folder=str(tmp_path / "port"),
                                 device="cpu", **kw)
    assert len(phist) == len(jhist) == 2 and phist[1] < phist[0]
    np.testing.assert_allclose(phist, jhist, rtol=TRAIN_LOSS_RTOL)
    for a, b in zip(ps.decoder_params, js.decoder_params):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=TRAIN_PARAM_TOL)
    # the npz each package wrote, read by the other, bitwise
    (jfile,) = (tmp_path / "jax").glob("*.npz")
    (pfile,) = (tmp_path / "port").glob("*.npz")
    assert jfile.name == pfile.name
    jload, pload = _pair(2, 31)
    assert pload.train_decoder_net(folder=str(tmp_path / "jax"),
                                   device="cpu") is None
    assert jload.train_decoder_net(folder=str(tmp_path / "port")) is None
    for a, b in zip(pload.decoder_params, js.decoder_params):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jload.decoder_params, ps.decoder_params):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_train_decoder_net_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    _, ps = _pair(2, 31)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.train_decoder_net(n_training_pts=64, folder=str(tmp_path),
                             load_file=False, save_file=False)


def test_load_keras_decoder_net_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    js, ps = _pair(2, 55)
    d, h, n = js.ssp_dim, 8, 2
    rng = np.random.default_rng(3)
    layers = {name: (rng.normal(size=(a, b)).astype(np.float32),
                     rng.normal(size=(b,)).astype(np.float32))
              for name, (a, b) in (("layer1", (d, d)), ("layer2", (d, h)),
                                   ("output", (h, n)))}
    path = str(tmp_path / "ref_decoder.h5")
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array([k.encode() for k in layers])
        for name, (k, b) in layers.items():
            g = mw.create_group(name).create_group(name)
            g.create_dataset("kernel:0", data=k)
            g.create_dataset("bias:0", data=b)
    for a, b in zip(ps.load_keras_decoder_net(path),
                    js.load_keras_decoder_net(path)):
        np.testing.assert_array_equal(a, np.asarray(b))
    phi = ps.encode(np.array([[0.2, -0.4]])).astype(np.float32)
    z = phi
    for name in ("layer1", "layer2"):
        k, b = layers[name]
        z = np.maximum(z @ k + b, 0.0)
    want = z @ layers["output"][0] + layers["output"][1]
    np.testing.assert_allclose(ps.decode(phi, "network", device="cpu"),
                               want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        _pair(2, 31)[1].load_keras_decoder_net(path)
