"""The allow_early_qr toggle (reference :301-302,768-801) in the real core.

The reference's ``_allow_early_QR`` starts the double-shift sweep below the
window top when two consecutive small subdiagonals make the bulge die at
introduction (LAPACK dlahqr's early-start device).  The crafted fixture
plants a subdiagonal at ~1e-16 * scale: the tightened Ahues-Tisseur product
test REJECTS deflating it (the early rounds), while the early-QR scan's
plain-ulp first-column test accepts starting there — so the toggle's code
path demonstrably fires from the first iteration.  Both settings must
produce an oracle-clean decomposition with the same spectrum.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.config import AlgoConfig
from periodicschurdecompositions_jax.ops.pqr_real import pqr_real_core


def _hess_cycle(rng, p, n, mtiny=None, tiny=0.0):
    """Hessenberg + upper-triangular cycle; optionally plant a tiny
    H0 subdiagonal at row ``mtiny`` (early-QR bait)."""
    H = np.zeros((p, n, n))
    H[0] = np.triu(rng.standard_normal((n, n)), -1)
    if mtiny is not None:
        H[0][mtiny, mtiny - 1] = tiny
    for f in range(1, p):
        H[f] = np.triu(rng.standard_normal((n, n)))
        np.fill_diagonal(H[f], 1.0 + rng.random(n))
    return H


def _prod_eigs(H):
    p = H.shape[0]
    prod = np.linalg.multi_dot(list(H)) if p > 1 else H[0]
    return np.sort_complex(np.linalg.eigvals(prod))


def _check(H, T, Z, tol):
    p, n = H.shape[:2]
    scale = np.abs(H).max()
    for f in range(p):
        r = np.abs(Z[f].T @ H[f] @ Z[(f + 1) % p] - T[f]).max()
        assert r / scale < tol, (f, r)
        assert np.abs(Z[f].T @ Z[f] - np.eye(n)).max() < tol


@pytest.mark.parametrize("p,n,mtiny,tiny", [
    (1, 12, 6, 1e-16), (3, 12, 5, 1e-16), (2, 16, None, 0.0),
    (1, 12, 6, 1e-14), (3, 12, 5, 1e-14)])
def test_early_qr_f64_core(rng, p, n, mtiny, tiny):
    H = _hess_cycle(rng, p, n, mtiny=mtiny, tiny=tiny)
    cfg = AlgoConfig(allow_early_qr=True)
    T, Z, wr, wi, ok = pqr_real_core(jnp.asarray(H), want_z=True, cfg=cfg)
    assert bool(ok)
    _check(H, np.asarray(T), np.asarray(Z), 1e-12)
    # same spectrum as the default path
    T0, _, wr0, wi0, ok0 = pqr_real_core(jnp.asarray(H), want_z=True,
                                         cfg=AlgoConfig())
    assert bool(ok0)
    w = np.sort_complex(np.asarray(wr) + 1j * np.asarray(wi))
    w0 = np.sort_complex(np.asarray(wr0) + 1j * np.asarray(wi0))
    sc = max(1.0, np.abs(w0).max())
    assert np.abs(w - w0).max() / sc < 1e-9
    # and the product oracle (multiset, moduli-sorted)
    wx = _prod_eigs(H)
    sx = max(1.0, np.abs(wx).max())
    assert np.abs(np.sort(np.abs(w)) - np.sort(np.abs(wx))).max() / sx < 1e-9
