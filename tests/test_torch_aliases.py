"""PyTorch port: the reference import paths (twin of
``tests/test_reference_aliases.py``), the package's exports against the
JAX package's, ``comp_eig_D``'s flat convention against JAX, and
``GPCSD1D.__str__`` against JAX's text."""

import numpy as np
import torch

import gpcsd_tpu
import gpcsd_tpu_torch
from torch_port_helpers import jax_small_model, port_of


def test_all_reference_import_paths():
    from gpcsd_tpu_torch.gpcsd1d import GPCSD1D  # noqa: F401
    from gpcsd_tpu_torch.gpcsd2d import GPCSD2D  # noqa: F401
    from gpcsd_tpu_torch.covariances import (  # noqa: F401
        GPCSD1DSpatialCovSE,
        GPCSD2DSpatialCovSE,
        GPCSDTemporalCovMatern,
        GPCSDTemporalCovSE,
    )
    from gpcsd_tpu_torch.priors import (  # noqa: F401
        GPCSDHalfNormalPrior,
        GPCSDInvGammaPrior,
        GPCSDPrior,
    )
    from gpcsd_tpu_torch.forward_models import b_fwd_1d, fwd_model_1d  # noqa: F401
    from gpcsd_tpu_torch.predict_csd import predictcsd_trad_1d  # noqa: F401
    from gpcsd_tpu_torch.utility_functions import (  # noqa: F401
        comp_eig_D,
        expand_grid,
        mykron,
        normalize,
        reduce_grid,
        sort_grid,
    )
    assert GPCSD1D is gpcsd_tpu_torch.GPCSD1D
    assert GPCSDInvGammaPrior is gpcsd_tpu_torch.InvGamma is gpcsd_tpu_torch.GPCSDInvGammaPrior


def test_exports_cover_the_jax_package():
    assert set(gpcsd_tpu.__all__) <= set(gpcsd_tpu_torch.__all__)
    for name in gpcsd_tpu_torch.__all__:
        assert hasattr(gpcsd_tpu_torch, name), name
    assert callable(gpcsd_tpu_torch.signal.bandpass_filtfilt)


def test_comp_eig_D_flat_convention(rng):
    """(Qs, Qt, flat Dvec) as the reference (utility_functions.py:44-64),
    the same Dvec as JAX's and the same dense covariance."""
    from gpcsd_tpu.utility_functions import comp_eig_D as j_comp
    from gpcsd_tpu_torch.utility_functions import comp_eig_D, mykron

    A = rng.normal(size=(4, 4))
    Ks = A @ A.T + 4 * np.eye(4)
    B = rng.normal(size=(6, 6))
    Kt = B @ B.T + 6 * np.eye(6)
    Qs, Qt, Dvec = comp_eig_D(torch.tensor(Ks), torch.tensor(Kt), 0.2)
    assert Dvec.shape == (24,)
    assert np.allclose(Dvec.numpy(), np.asarray(j_comp(Ks, Kt, 0.2)[2]), rtol=1e-12, atol=0)
    Q = mykron(Qs, Qt).numpy()
    assert np.allclose(Q @ np.diag(Dvec.numpy()) @ Q.T, np.kron(Ks, Kt) + 0.2 * np.eye(24), atol=1e-8)


def test_gpcsd1d_str_matches_jax():
    for per_channel in (False, True):
        jm = jax_small_model(per_channel=per_channel)
        assert str(port_of(jm)) == str(jm)


def test_gpcsd1d_spatial_cov_base_class():
    """``gpcsd_tpu_torch.covariances.GPCSD1DSpatialCov`` is the 1D spatial
    base class, as in the JAX package: the SE covariance subclasses it, and
    its quadrature rule equals JAX's."""
    from gpcsd_tpu.models.covariances import GPCSD1DSpatialCov as JBase
    from gpcsd_tpu_torch.covariances import GPCSD1DSpatialCov, GPCSD1DSpatialCovSE

    assert issubclass(GPCSD1DSpatialCovSE, GPCSD1DSpatialCov)
    x = np.linspace(0.0, 2300.0, 24).reshape(-1, 1)
    base, want = GPCSD1DSpatialCov(x, a=-200.0, b=2600.0, ngl=60), JBase(x, a=-200.0, b=2600.0, ngl=60)
    se = GPCSD1DSpatialCovSE(x, a=-200.0, b=2600.0, ngl=60)
    assert isinstance(se, GPCSD1DSpatialCov)
    for obj in (base, se):
        assert (obj.a, obj.b, obj.ngl) == (want.a, want.b, want.ngl) == (-200.0, 2600.0, 60)
        np.testing.assert_array_equal(obj.x, want.x)
        np.testing.assert_allclose(obj.gl_x, np.asarray(want.gl_x), rtol=1e-15, atol=1e-12)
        np.testing.assert_allclose(obj.gl_w, np.asarray(want.gl_w), rtol=1e-14)
    default = GPCSD1DSpatialCov(x)
    assert (default.a, default.b, default.ngl) == (0.0, 2300.0, 100)


def test_temporal_param_names():
    from gpcsd_tpu.models.core import temporal_param_names as want
    from gpcsd_tpu_torch.models.core import temporal_param_names

    for n in (0, 1, 2, 3):
        assert temporal_param_names(n) == want(n)
    assert temporal_param_names(2) == [("tm0_ell", "tm0_sigma2"), ("tm1_ell", "tm1_sigma2")]
    tm = port_of(jax_small_model())
    names = [n for pair in temporal_param_names(len(tm.temporal_cov_list)) for n in pair]
    assert set(names) <= set(tm._theta())
