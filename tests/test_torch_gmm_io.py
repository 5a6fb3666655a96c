"""The port's GMM surface against the JAX package's
(``priors/patches/gmm.py``): the full log-probability matrix in torch and
in float64 numpy, the constructors (``from_sklearn_gmm``,
``from_registry(**kwargs)``), every ``read`` format and ``write``, and the
diagnostics (``reduce_to_topk``, ``covariance_det``, the KL divergences,
``is_equal``, ``eigen_images``, ``__str__``).

Tolerances: the torch log-probabilities within 1e-6 of their max-abs
(float32 products summed in another order); everything computed on the
host from the same float32 arrays exactly, or within 1e-12 relative where
a float64 sum runs in another order.
"""

import numpy as np
import pytest
import scipy.io
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj

torch.set_num_threads(1)

TG, JG = jt.GaussianMixtureModel, jj.GaussianMixtureModel


def random_gmm_arrays(k=5, npix=3, seed=0):
    rs = np.random.RandomState(seed)
    d = npix * npix
    a = rs.standard_normal((k, d, d))
    covariances = a @ a.transpose(0, 2, 1) / d + 0.1 * np.eye(d)
    means = rs.standard_normal((k, d))
    weights = rs.dirichlet(np.ones(k))
    return means, covariances, weights


def both(arrays):
    return TG.from_numpy(*arrays), JG.from_numpy(*arrays)


def same_gmm(a, b):
    for name in ("means", "covariances", "weights", "precisions_cholesky"):
        assert_array_equal(np.asarray(getattr(a, name)),
                           np.asarray(getattr(b, name)), err_msg=name)
    assert a.meta.stride == b.meta.stride
    assert a.meta.patch_norm.to_dict() == b.meta.patch_norm.to_dict()


def test_estimate_log_prob_matches():
    gmm_t = TG.from_registry("astro-snr-v1")
    gmm_j = JG.from_registry("astro-snr-v1")
    x = np.random.RandomState(1).standard_normal((300, 64)).astype(
        np.float32)
    got = gmm_t.estimate_log_prob(torch.as_tensor(x)).numpy()
    want = np.asarray(gmm_j.estimate_log_prob(jnp.asarray(x)))
    assert got.shape == want.shape == (300, 200)
    assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    got64 = gmm_t.estimate_log_prob_numpy(x)
    assert_allclose(got64, gmm_j.estimate_log_prob_numpy(x), rtol=1e-12)
    assert_allclose(got, got64, rtol=0, atol=1e-6 * np.abs(got64).max())


def test_from_sklearn_gmm_matches():
    mixture = pytest.importorskip("sklearn.mixture")
    rs = np.random.RandomState(2)
    data = np.concatenate([rs.normal(-2, 1, (200, 4)),
                           rs.normal(3, 0.5, (200, 4))])
    fitted = mixture.GaussianMixture(n_components=2, random_state=0).fit(data)
    same_gmm(TG.from_sklearn_gmm(fitted), JG.from_sklearn_gmm(fitted))


def test_from_registry_takes_read_keywords(tmp_path):
    """``from_registry(name, **kwargs)`` reads the entry with the caller's
    keywords over the entry's: here a file of the caller's."""
    arrays = random_gmm_arrays(npix=8)
    JG.from_numpy(*arrays).write(tmp_path / "mine.npz")
    got = TG.from_registry("astro-snr-v1", filename=tmp_path / "mine.npz")
    want = JG.from_registry("astro-snr-v1",
                            filename=str(tmp_path / "mine.npz"))
    same_gmm(got, want)
    assert got.to_dict() == {"type": "astro-snr-v1"}


def epll_mat(path, arrays, name):
    means, covariances, weights = arrays
    fields = {"covs": covariances.T, "mixweights": weights[:, None]}
    if name == "GS":
        fields["means"] = means.T
    scipy.io.savemat(str(path), {name: fields})


@pytest.mark.parametrize("fmt", ["npz", "epll-matlab", "epll-matlab-16x16"])
def test_read_formats_match(fmt, tmp_path):
    arrays = random_gmm_arrays(npix=4)
    path = tmp_path / "gmm.file"
    if fmt == "npz":
        path = tmp_path / "gmm.npz"
        JG.from_numpy(*arrays).write(path)
    else:
        epll_mat(path, arrays, "GS" if fmt == "epll-matlab" else "GMM")
    same_gmm(TG.read(path, format=fmt), JG.read(path, format=fmt))


def test_table_format_needs_astropy(tmp_path):
    try:
        import astropy  # noqa: F401
    except ImportError:
        for cls in (TG, JG):
            with pytest.raises(ImportError, match="astropy"):
                cls.read(tmp_path / "gmm.fits", format="table")
    with pytest.raises(ValueError, match="Not a supported format"):
        TG.read(tmp_path / "gmm.npz", format="csv")


def test_write_reads_in_the_jax_package(tmp_path, monkeypatch):
    """The port's ``npz`` (stride and patch norm included) reads in the
    JAX package, ``$VARIABLES`` in the name expand."""
    arrays = random_gmm_arrays(npix=8)
    gmm = TG.from_registry("builtin-8x8-v1").reduce_to_topk(7)
    gmm.write(tmp_path / "port.npz")
    monkeypatch.setenv("GMM_DIR", str(tmp_path))
    same_gmm(JG.read("$GMM_DIR/port.npz"), TG.read("$GMM_DIR/port.npz"))
    other = TG.from_numpy(*arrays)
    other.write(tmp_path / "plain.npz")
    same_gmm(JG.read(tmp_path / "plain.npz"), TG.read(tmp_path / "plain.npz"))
    assert_array_equal(np.asarray(JG.read(tmp_path / "plain.npz").means),
                       other.means)


def test_diagnostics_match():
    gmm_t = TG.from_registry("astro-snr-v1")
    gmm_j = JG.from_registry("astro-snr-v1")
    same_gmm(gmm_t.reduce_to_topk(12), gmm_j.reduce_to_topk(12))
    assert gmm_t.covariance_det == gmm_j.covariance_det
    assert_array_equal(gmm_t.eigen_images[:5], gmm_j.eigen_images[:5])
    assert gmm_t.is_equal(gmm_t) and not gmm_t.is_equal(
        gmm_t.reduce_to_topk(3))
    singles = [both(random_gmm_arrays(k=1, npix=3, seed=s)) for s in (3, 4)]
    (a_t, a_j), (b_t, b_j) = singles
    assert_allclose(a_t.kl_divergence(b_t), a_j.kl_divergence(b_j),
                    rtol=1e-12)
    assert_allclose(a_t.symmetric_kl_divergence(b_t),
                    a_j.symmetric_kl_divergence(b_j), rtol=1e-12)
    with pytest.raises(ValueError, match="single component"):
        gmm_t.kl_divergence(gmm_t)
    assert str(gmm_t) == str(gmm_j)
    inline_t, inline_j = both(random_gmm_arrays(k=2, npix=2))
    assert str(inline_t) == str(inline_j)
