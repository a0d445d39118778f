"""The native seam of the port's solvers, qr and eig, swapped for the CPU
tests: scipy's BLAS and LAPACK for the triangular solves and factorizations
and numpy's `@` for the small products in the port, and numpy's `@` for
JAX's eager `@` too. JAX's own CPU pieces are scipy's bit for bit:
triangular_solve is BLAS trsm (scipy.linalg.solve_triangular, LAPACK trtrs,
differs from it on one-column right-hand sides), lu is getrf, cholesky
potrf, qr(mode="raw") geqrf and eigh syevd. So with the seam swapped both
packages compute the same native pieces, and everything else -- block
loops, flips, gathers, masks and the emulated updates -- is meant to give
the same bits."""
import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import scipy.linalg
import scipy.linalg.blas
import torch

from gemmul8_tpu_torch import eig, solvers

# the package exports the qr() function under the submodule's name
qr = importlib.import_module("gemmul8_tpu_torch.qr")


def _np(x):
    return np.ascontiguousarray(x.resolve_conj().resolve_neg().numpy())


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _trsm(t, rhs, *, lower, unit_diag=False):
    """T X = rhs by BLAS trsm, as jax.lax.linalg.triangular_solve calls it."""
    t, rhs = _np(t), _np(rhs)
    trsm = scipy.linalg.blas.get_blas_funcs("trsm", (t, rhs))
    return _t(trsm(1.0, t, rhs, side=0, lower=int(lower), trans_a=0,
                   diag=int(unit_diag)))


def tri_solve(t, rhs, *, unit_diag):
    return _trsm(torch.tril(t), rhs, lower=True, unit_diag=unit_diag)


def small_matmul(x, y):
    return _t(_np(x) @ _np(y))


def panel_lu(a):
    lu, piv = scipy.linalg.lu_factor(_np(a))
    return _t(lu), _t(solvers._pivots_to_perm(piv, a.shape[0]))


def chol(a):
    return _t(scipy.linalg.cholesky(_np(a), lower=True))


def tri_inv_upper(m):
    return _trsm(m, torch.eye(m.shape[0], dtype=m.dtype), lower=False)


def panel_qr(panel):
    (h, tau), _ = scipy.linalg.qr(_np(panel), mode="raw")
    return _t(h), _t(tau)


def eigh_small(g):
    g = _np(g)
    syevd = scipy.linalg.get_lapack_funcs(
        "heevd" if np.iscomplexobj(g) else "syevd", (g,))
    pairs = [syevd(x, compute_v=1, lower=1)[:2] for x in g]
    return (_t(np.stack([w for w, _ in pairs])),
            _t(np.stack([v for _, v in pairs])))


PORT_SEAM = ((solvers, "_tri_solve_native", tri_solve),
             (solvers, "_small_matmul", small_matmul),
             (solvers, "_panel_lu", panel_lu),
             (solvers, "_chol_native", chol),
             (qr, "_tri_inv_upper", tri_inv_upper),
             (qr, "_panel_qr", panel_qr),
             (eig, "_eigh_small", eigh_small))


@contextlib.contextmanager
def swapped():
    """The port's seam on scipy/numpy and JAX's eager `@` on numpy's, for
    the duration of the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in PORT_SEAM]
    array_type = type(jnp.ones(2))
    jax_matmul = array_type.__matmul__
    for mod, name, fn in PORT_SEAM:
        setattr(mod, name, fn)
    array_type.__matmul__ = lambda x, y: jnp.asarray(
        np.asarray(x) @ np.asarray(y))
    try:
        yield
    finally:
        array_type.__matmul__ = jax_matmul
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def bits_equal(got, ref):
    """got (a torch tensor) holds ref's (a JAX or numpy array's) dtype,
    shape and bits."""
    got, ref = _np(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (
        got.dtype, ref.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))
