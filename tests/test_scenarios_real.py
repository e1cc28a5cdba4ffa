"""Real periodic Schur scenarios through the public API (float64 core).

The scenario families of the reference's own tests (test/runtests.jl,
test/testfuncs.jl): random and graded cycles, exponentially split spectra,
long periods up to p=20, singular factors, both orientations, the
eigenvalue-only fast path and edge sizes.  Every case checks the
reference's oracles: the contract (check_psd), quasi-triangular structure,
and eigenvalues against ``eigvals`` of the explicit product.  Cycles share
n=6 so each period compiles once.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import periodicschurdecompositions_jax as psd

N = 6
PERIODS = [2, 3, 6, 12, 20]


def match_error(a, b):
    """Largest distance after pairing each value of ``a`` greedily with the
    nearest unused value of ``b``."""
    rest = list(np.asarray(b, complex))
    worst = 0.0
    for x in sorted(np.asarray(a, complex), key=lambda z: -abs(z)):
        d = np.abs(np.asarray(rest) - x)
        j = int(np.argmin(d))
        worst = max(worst, float(d[j]))
        rest.pop(j)
    return worst


def product(A, lr):
    M = np.eye(A.shape[1])
    for a in (A if lr == "R" else A[::-1]):
        M = M @ a
    return M


def check(A, lr="R", res_tol=100.0, eig_tol=1e-9, **kw):
    P = psd.pschur(jnp.asarray(A), lr, **kw)
    p, n, _ = A.shape
    vals = np.asarray(P.values)
    if kw.get("want_z", True) and kw.get("want_t", True):
        ok, rep = psd.check_psd(P, A, tol=res_tol)
        assert ok, rep
        T = np.asarray(P.Ts)
        for l in range(p):
            k = -1 if l == P.schurindex else 0
            assert np.all(np.tril(T[l], k - 1) == 0.0), l
    w = np.linalg.eigvals(product(A, lr))
    scale = max(np.abs(w).max(), 1e-300)
    err = match_error(vals, w) / scale
    assert err < eig_tol, err
    return P


def graded(rng, p, n):
    """Every other factor graded by rows and columns over six decades."""
    g = 10.0 ** np.linspace(-3, 3, n)
    return np.stack([g[:, None] * rng.standard_normal((n, n)) / g[None, :]
                     if l % 2 == 0 else rng.standard_normal((n, n))
                     for l in range(p)])


def exp_split(rng, p, n, fac):
    """Triangular factors with diagonals fac^k mixed by orthogonal
    similarities: the cycle's eigenvalues span fac^p .. fac^(3p)."""
    q = [np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(p)]
    A = []
    for l in range(p):
        d = fac ** (1 + 2 * rng.random(n))
        T = np.triu(rng.standard_normal((n, n)), 1) * d.max() * 0.1
        np.fill_diagonal(T, d)
        A.append(q[l] @ T @ q[(l + 1) % p].T)
    return np.stack(A)


@pytest.mark.parametrize("lr", ["R", "L"])
@pytest.mark.parametrize("p", PERIODS)
def test_random_cycle(rng, p, lr):
    check(rng.standard_normal((p, N, N)), lr)


@pytest.mark.parametrize("p", [2, 3, 6, 12])
def test_graded_cycle(rng, p):
    check(graded(rng, p, N), eig_tol=1e-8)


@pytest.mark.parametrize("p,fac", [(3, 0.1), (6, 0.5), (12, 0.5), (20, 2.0)])
def test_exp_split_cycle(rng, p, fac):
    check(exp_split(rng, p, N, fac), eig_tol=1e-8)


@pytest.mark.parametrize("hole", [0, N - 1])
@pytest.mark.parametrize("p", [3, 6, 12])
def test_singular_factor(rng, p, hole):
    """A factor with an exact zero diagonal in triangular form: the
    product is singular and exactly one eigenvalue is (numerically) zero."""
    A = rng.standard_normal((p, N, N))
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    T = np.triu(rng.standard_normal((N, N))) + 2 * np.eye(N)
    T[hole, hole] = 0.0
    A[1] = q @ T @ q.T
    P = check(A)
    mags = np.sort(np.abs(np.asarray(P.values)))
    assert mags[0] < 1e-12 * mags[-1]
    assert mags[1] > 1e-8 * mags[-1]


@pytest.mark.parametrize("p", [2, 6, 12])
def test_eigenvalues_only(rng, p):
    """want_t=False, want_z=False: the windowed fast path gives the same
    spectrum as the product."""
    P = check(rng.standard_normal((p, N, N)), want_t=False, want_z=False)
    assert P.Zs is None or np.asarray(P.Zs).shape[-1] <= 1


@pytest.mark.parametrize("p", [3, 20])
@pytest.mark.parametrize("n", [1, 2])
def test_edge_sizes(rng, p, n):
    check(rng.standard_normal((p, n, n)))
