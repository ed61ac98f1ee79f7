"""PyTorch port, the numpy stages: ``utils/segmentation`` (labels equal to
the JAX package's, bit for bit), ``models/kcsd`` over the port's forward
operator (the same (R, lambda) chosen by cross-validation, ``values()`` to
1e-7 of its largest magnitude: the kernel is ill-conditioned, see the test)
and ``models/trad`` (equal)."""

import numpy as np
import pytest

from gpcsd_tpu.models.kcsd import KCSD1D as JKCSD
from gpcsd_tpu.models.trad import predictcsd_trad_1d as j_trad1, predictcsd_trad_2d as j_trad2
from gpcsd_tpu.ops.forward import fwd_model_1d as j_fwd
from gpcsd_tpu.utils import segmentation as JS
from gpcsd_tpu_torch.models.kcsd import KCSD1D as TKCSD
from gpcsd_tpu_torch.models.trad import predictcsd_trad_1d, predictcsd_trad_2d
from gpcsd_tpu_torch.utils import segmentation as TS


def bumps(signed):
    xx, tt = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
    a = np.exp(-((xx - 10) ** 2 + (tt - 12) ** 2) / 35.0)
    b = np.exp(-((xx - 30) ** 2 + (tt - 27) ** 2) / 35.0)
    return a - b if signed else a + b


def evoked_image():
    """A dipole evoked-CSD image like ``fit_mean_function``'s, with noise."""
    z, t = np.linspace(0, 2300, 93)[:, None], np.linspace(0, 60, 50)[None, :]
    img = np.exp(-((z - 600) ** 2) / (2 * 180**2)) * np.exp(-((t - 20) ** 2) / 32.0)
    img -= np.exp(-((z - 1600) ** 2) / (2 * 160**2)) * np.exp(-((t - 35) ** 2) / 50.0)
    return img + 0.02 * np.random.default_rng(0).normal(size=img.shape)


@pytest.mark.parametrize("case", [
    (lambda: bumps(False), 0.5, 8), (lambda: bumps(True), 0.5, 8),
    (evoked_image, 0.45, 12), (evoked_image, 0.2, 5),
])
def test_segment_csd_labels_equal(case):
    make, rel, dist = case
    img = make()
    got, n = TS.segment_csd(img, rel_threshold=rel, min_distance=dist)
    want, nj = JS.segment_csd(img, rel_threshold=rel, min_distance=dist)
    assert n == nj and n >= 2
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_markers_and_watershed_equal():
    img = evoked_image()
    m, k = TS.local_extrema_markers(img, 0.3, 4)
    mj, kj = JS.local_extrema_markers(img, 0.3, 4)
    assert k == kj and np.array_equal(m, mj)
    mask = np.abs(img) > 0.1
    assert np.array_equal(TS.watershed(-np.abs(img), m, mask), JS.watershed(-np.abs(img), mj, mask))
    assert np.array_equal(TS.segment_csd(np.zeros((5, 5)))[0], JS.segment_csd(np.zeros((5, 5)))[0])


def kcsd_case(noise):
    z, t = np.linspace(0, 2000, 201), np.linspace(0, 40, 12)
    x = np.linspace(0, 2000, 24).reshape(-1, 1)
    csd = np.exp(-((z[:, None] - 600) ** 2) / (2 * 150**2)) * np.exp(-((t[None] - 20) ** 2) / 32.0)
    lfp = np.array(j_fwd(csd, z, x.ravel(), 150.0))
    lfp /= np.abs(lfp).max()
    return x, lfp + noise * np.random.default_rng(1).normal(size=lfp.shape)


@pytest.mark.parametrize("noise,gdx", [(0.02, 10.0), (0.05, 25.0)])
def test_kcsd_cross_validate_and_values(noise, gdx):
    x, lfp = kcsd_case(noise)
    # noisy data and lambda from 1e-4 up: K has condition number ~2e8, so
    # on clean data or at smaller lambda the LOO errors are the two
    # packages' roundoff amplified by inv(K + lambda I), and either may win;
    # here they agree to ~5e-8.  values() solves with K + lambda I at the
    # chosen lambda: the kernels' 2.5e-16 difference times its condition
    # number gives ~1e-8 of the largest value, held to 1e-7
    Rs, lams = np.linspace(100, 500, 5), np.logspace(-4, 0, 9)
    kt, kj = TKCSD(x, lfp, gdx=gdx, h=150.0), JKCSD(x, lfp, gdx=gdx, h=150.0)
    assert kt.cross_validate(Rs, lams) == kj.cross_validate(Rs, lams)
    assert abs(kt.cv_error - kj.cv_error) <= 1e-6 * kj.cv_error
    got, want = kt.values(), kj.values()
    assert got.shape == want.shape == (kt.estm_x.size, lfp.shape[1])
    assert np.max(np.abs(got - want)) <= 1e-7 * np.max(np.abs(want))


def test_trad_equal():
    lfp = np.random.default_rng(2).normal(size=(8, 5, 3))
    assert np.array_equal(predictcsd_trad_1d(lfp), j_trad1(lfp))
    lfp2 = np.random.default_rng(3).normal(size=(4, 6, 5, 2))
    assert np.array_equal(predictcsd_trad_2d(lfp2), j_trad2(lfp2), equal_nan=True)
