"""Split-complex (re, im pair) pipeline vs the complex128 core.

The split core (ops/pqz_complex_split.py) runs the complex QZ iteration on
(re, im) float64 pairs; it must reproduce the complex128
core's contracts: reconstruction, unitarity, triangularity, eigenvalues vs
the explicit product (SURVEY §4 oracles), planted singular factors.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.ops.cxkern import CX, givens_cx
from periodicschurdecompositions_jax.ops.pqz_complex_split import (
    phessenberg_core_split, pqz_complex_core_split)
from periodicschurdecompositions_jax.ops.hessenberg import (
    phessenberg_core, phessenberg_signed_core)

EPS = np.finfo(np.float64).eps


def _assemble(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _run_split(A, S, reduce_signed=False):
    p, n, _ = A.shape
    if reduce_signed:
        H, Q = phessenberg_signed_core(jnp.asarray(A), S, want_q=True)
        Hn, Qn = np.asarray(H), np.asarray(Q)
        args = (jnp.asarray(Hn.real.copy()), jnp.asarray(Hn.imag.copy()), S,
                jnp.asarray(Qn.real.copy()), jnp.asarray(Qn.imag.copy()))
    else:
        Hre, Him, Qre, Qim = phessenberg_core_split(
            jnp.asarray(A.real.copy()), jnp.asarray(A.imag.copy()))
        args = (Hre, Him, S, Qre, Qim)
    out = pqz_complex_core_split(*args)
    (Tre, Tim, Zre, Zim, alr, ali, be, sc, ok) = out
    assert bool(ok)
    T = _assemble(Tre, Tim)
    Z = _assemble(Zre, Zim)
    alpha = _assemble(alr, ali)
    return T, Z, alpha, np.asarray(be), np.asarray(sc)


def _check(A, S, T, Z, alpha, beta, scal, tol=200):
    p, n, _ = A.shape
    for l in range(p):
        if S[l]:
            R = Z[l] @ T[l] @ Z[(l + 1) % p].conj().T - A[l]
        else:
            R = Z[(l + 1) % p] @ T[l] @ Z[l].conj().T - A[l]
        assert np.abs(R).max() < tol * EPS * n * np.abs(A).max(), \
            f"factor {l}: {np.abs(R).max():.2e}"
        assert np.abs(Z[l] @ Z[l].conj().T - np.eye(n)).max() < tol * EPS * n
        assert np.abs(np.tril(T[l], -1)).max() == 0
    # eigenvalues vs the explicit signed product
    prod = np.eye(n, dtype=complex)
    for l in range(p):
        prod = prod @ (A[l] if S[l] else np.linalg.inv(A[l]))
    w_ref = np.sort_complex(np.linalg.eigvals(prod))
    finite = beta != 0
    vals = np.where(finite, alpha / np.where(finite, beta, 1.0), np.inf) * \
        np.exp2(scal.astype(float))
    w = np.sort_complex(vals)
    lscale = max(np.abs(w_ref).max(), 1.0)
    assert np.abs(w - w_ref).max() < 5000 * EPS * n * lscale, \
        f"eig err {np.abs(w - w_ref).max():.2e}"


@pytest.mark.parametrize("p,n", [(1, 6), (2, 8), (4, 10)])
def test_split_all_positive(p, n, rng):
    A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
    S = (True,) * p
    T, Z, alpha, beta, scal = _run_split(A, S)
    _check(A, S, T, Z, alpha, beta, scal)


def test_split_hessenberg_contract(rng):
    p, n = 3, 12
    A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
    Hre, Him, Qre, Qim = phessenberg_core_split(
        jnp.asarray(A.real.copy()), jnp.asarray(A.imag.copy()))
    H = _assemble(Hre, Him)
    Q = _assemble(Qre, Qim)
    for l in range(p):
        R = Q[l] @ H[l] @ Q[(l + 1) % p].conj().T - A[l]
        assert np.abs(R).max() < 100 * EPS * n * np.abs(A).max()
    assert np.abs(np.tril(H[0], -2)).max() == 0
    for l in range(1, p):
        assert np.abs(np.tril(H[l], -1)).max() == 0
    # agrees with the complex128 reduction's contract (not bitwise)
    H2, Q2 = phessenberg_core(jnp.asarray(A), want_q=True)
    d1 = np.sort(np.abs(np.diagonal(np.asarray(H2)[1], 0)))
    d2 = np.sort(np.abs(np.diagonal(H[1], 0)))
    assert np.allclose(d1, d2, rtol=1e-10)


def test_split_mixed_signature(rng):
    p, n = 3, 8
    S = (True, False, True)
    A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
    for l in range(p):
        A[l] += 2.0 * np.eye(n)  # keep inverted factors well-conditioned
    T, Z, alpha, beta, scal = _run_split(A, S, reduce_signed=True)
    _check(A, S, T, Z, alpha, beta, scal)


def test_split_planted_hole(rng):
    """Zero diagonal planted in a direct factor (deflate_pos branch)."""
    p, n = 3, 8
    S = (True, True, True)
    A = [np.triu(rng.standard_normal((n, n)) +
                 1j * rng.standard_normal((n, n))) for _ in range(p)]
    A[1][3, 3] = 0.0
    A[0] = (rng.standard_normal((n, n)) +
            1j * rng.standard_normal((n, n)))  # full Hessenberg source
    A = np.stack(A)
    T, Z, alpha, beta, scal = _run_split(A, S)
    # the planted zero must surface as a zero eigenvalue
    vals = alpha / np.where(beta == 0, 1.0, beta) * np.exp2(scal.astype(float))
    assert np.abs(vals).min() < 1e-10
    for l in range(p):
        R = Z[l] @ T[l] @ Z[(l + 1) % p].conj().T - A[l]
        assert np.abs(R).max() < 200 * EPS * n * np.abs(A).max()


def test_split_inverted_hole(rng):
    """Zero diagonal planted in an inverted factor (deflate_neg branch) ->
    infinite eigenvalue (beta == 0).  Planted on a PRE-REDUCED cycle (like
    the complex128 planted-hole tests): a reduction would smear the exact
    zero to eps level."""
    p, n = 3, 8
    S = (True, False, True)
    H = np.zeros((p, n, n), complex)
    H[0] = np.triu(rng.standard_normal((n, n)) +
                   1j * rng.standard_normal((n, n)), -1)
    for l in range(1, p):
        H[l] = np.triu(rng.standard_normal((n, n)) +
                       1j * rng.standard_normal((n, n))) + 2 * np.eye(n)
    H[1][4, 4] = 0.0  # inverted factor -> infinite eigenvalue
    out = pqz_complex_core_split(
        jnp.asarray(H.real.copy()), jnp.asarray(H.imag.copy()), S)
    (Tre, Tim, Zre, Zim, alr, ali, be, sc, ok) = out
    assert bool(ok)
    beta = np.asarray(be)
    assert (beta == 0).sum() >= 1
    T = _assemble(Tre, Tim)
    Z = _assemble(Zre, Zim)
    for l in range(p):
        if S[l]:
            R = Z[l] @ T[l] @ Z[(l + 1) % p].conj().T - H[l]
        else:
            R = Z[(l + 1) % p] @ T[l] @ Z[l].conj().T - H[l]
        assert np.abs(R).max() < 200 * EPS * n * np.abs(H).max()


def test_givens_cx_matches_complex(rng):
    from periodicschurdecompositions_jax.ops.rotations import givens_complex
    f = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    g = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    g[7] = 0.0
    f[9] = 0.0
    c1, s1, r1 = givens_complex(jnp.asarray(f), jnp.asarray(g))
    c2, s2, r2 = givens_cx(CX(jnp.asarray(f.real), jnp.asarray(f.imag)),
                           CX(jnp.asarray(g.real), jnp.asarray(g.imag)))
    assert np.allclose(np.asarray(c1), np.asarray(c2), atol=1e-14)
    assert np.allclose(np.asarray(s1), _assemble(s2.re, s2.im), atol=1e-14)
    assert np.allclose(np.asarray(r1), _assemble(r2.re, r2.im), atol=1e-13)


def test_driver_split_backend(rng):
    import periodicschurdecompositions_jax as psd
    p, n = 2, 7
    A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
    P1 = psd.pschur(jnp.asarray(A), "R", backend="complex")
    P2 = psd.pschur(jnp.asarray(A), "R", backend="split")
    w1 = np.sort_complex(np.asarray(P1.values))
    w2 = np.sort_complex(np.asarray(P2.values))
    assert np.abs(w1 - w2).max() < 1e-10 * max(np.abs(w1).max(), 1.0)
