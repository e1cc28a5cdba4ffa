"""End-to-end tests for the real periodic QR core (flagship path).

Mirrors reference oracles: quasi-triangularity, zero-subdiagonal-iff-real-
eigenvalue, orthogonality, per-factor reconstruction, eigenvalues vs
eigvals(prod(A)) matched as real/conjugate multisets (test/testfuncs.jl).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.models.drivers import pschur
from periodicschurdecompositions_jax.diagnostics import check_psd

EPS = np.finfo(np.float64).eps


def compare_real_eigs(w, wx, tol):
    """Sorted-by-|.| multiset comparison for real/conjugate-pair spectra."""
    w = sorted(w, key=abs)
    wx = sorted(wx, key=abs)
    scale = max(abs(z) for z in w) or 1.0
    i = 0
    while i < len(w):
        if abs(w[i].imag) < 1e-8 * scale:
            assert abs(w[i] - wx[i]) < tol * scale or \
                abs(w[i] - np.conj(wx[i])) < tol * scale, (i, w[i], wx[i])
            i += 1
        else:
            a, b = w[i], w[i + 1]
            c, d = wx[i], wx[i + 1]
            if a.imag * c.imag < 0:
                c, d = d, c
            assert abs(a - c) < tol * scale, (i, a, c)
            assert abs(b - d) < tol * scale, (i, b, d)
            i += 2


def full_check(A, lr="R", tol_eig=1000):
    A = np.asarray(A)
    p, n, _ = A.shape
    P = pschur(jnp.asarray(A), lr)
    ok, rep = check_psd(P, A, tol=200.0)
    assert ok, rep
    # zero-subdiag-iff-real-eigenvalue on the Schur factor
    T1 = np.asarray(P.T1)
    vals = np.asarray(P.values)
    # reconstruct product eigenvalues
    if lr == "R":
        prod = np.linalg.multi_dot(list(A)) if p > 1 else A[0]
    else:
        prod = np.linalg.multi_dot(list(A[::-1])) if p > 1 else A[0]
    w = np.linalg.eigvals(prod)
    compare_real_eigs(w, vals, tol_eig * EPS * n)
    return P


class TestRealPSD:
    @pytest.mark.parametrize("p,n", [(1, 8), (2, 8), (3, 9), (5, 6)])
    def test_random(self, rng, p, n):
        A = rng.standard_normal((p, n, n))
        full_check(A)

    def test_left(self, rng):
        A = rng.standard_normal((4, 7, 7))
        full_check(A, lr="L")

    def test_moderate(self, rng):
        A = rng.standard_normal((2, 24, 24))
        full_check(A, tol_eig=1e5)

    def test_symmetric_spectrum(self, rng):
        # orthogonal-ish cycle: eigenvalues on/near unit circle, many pairs
        q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        A = np.stack([q, q.T, q @ q, rng.standard_normal((6, 6)) * 0.1])
        full_check(A, tol_eig=1e5)

    def test_expsplit(self, rng):
        # Kressner exponentially-split spectrum (test/testfuncs.jl:412-421)
        fac = 0.1
        p = 5
        A1 = np.array([[9, 4, 1, 4, 3, 4], [6, 8, 2, 4, 0, 2],
                       [0, 7, 4, 4, 6, 6], [0, 0, 8, 4, 6, 7],
                       [0, 0, 0, 8, 9, 3], [0, 0, 0, 0, 5, 0]], float)
        Aj = np.diag([fac, fac ** 2, fac ** 3, 1, 1, 1])
        A = np.stack([A1] + [Aj] * (p - 1))
        P = pschur(jnp.asarray(A))
        ok, rep = check_psd(P, A, tol=200.0)
        assert ok, rep
        lam = np.asarray(P.values)
        lam_known = [15.6284, -1.31418 - 3.51424j, -1.31418 + 3.51424j,
                     90 * fac ** p, (1600 / 3) * fac ** (2 * p),
                     -(71750 / 11) * fac ** (3 * p)]
        lam_s = sorted(lam, key=abs)
        known_s = sorted(lam_known, key=abs)
        for a, b in zip(lam_s, known_s):
            err = min(abs(a - b), abs(a - np.conj(b)))
            assert err < 2e-4 * max(1, abs(b)), (a, b)

    def test_n1_n2(self, rng):
        A = rng.standard_normal((3, 1, 1))
        P = pschur(jnp.asarray(A))
        assert abs(complex(np.asarray(P.values)[0])
                   - float(A[0, 0, 0] * A[1, 0, 0] * A[2, 0, 0])) < 1e-12
        A2 = rng.standard_normal((3, 2, 2))
        full_check(A2)

    def test_want_z_false(self, rng):
        A = rng.standard_normal((3, 6, 6))
        P = pschur(jnp.asarray(A), want_z=False)
        P2 = pschur(jnp.asarray(A))
        w1 = sorted(np.asarray(P.values), key=abs)
        w2 = sorted(np.asarray(P2.values), key=abs)
        assert np.allclose(w1, w2, atol=1e-10)
