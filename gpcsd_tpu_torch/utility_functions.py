"""Reference import-path alias (``gpcsd.utility_functions``).

``comp_eig_D`` keeps the reference's return convention, (Qs, Qt, flat
Dvec) with ``Dvec = repeat(lam_s, nt) * tile(lam_t, nx) + sig2n``
(``utility_functions.py:44-64``), on top of the factored engine; it takes
and returns tensors on the device of ``Ks``.
"""

from .ops.kronlik import comp_eig_d, mykron  # noqa: F401
from .utils.grids import expand_grid, normalize, reduce_grid, sort_grid  # noqa: F401


def comp_eig_D(Ks, Kt, sig2n):
    fac = comp_eig_d(Ks, Kt, sig2n)
    return fac.qs, fac.qt, fac.d.reshape(-1)
