"""Native C++ host backend vs ground truth (SURVEY §4 oracles)."""
import numpy as np
import pytest

from periodicschurdecompositions_jax import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native host library unavailable")


@pytest.mark.parametrize("p,n", [(1, 8), (2, 8), (4, 12), (3, 16), (8, 24)])
def test_native_pschur(p, n):
    rng = np.random.default_rng(100 * p + n)
    A = rng.standard_normal((p, n, n))
    T, Z, wr, wi = native.pschur_real_cpu(A)
    eps = np.finfo(np.float64).eps
    scale = np.abs(A).max()
    for l in range(p):
        R = Z[l] @ T[l] @ Z[(l + 1) % p].T - A[l]
        assert np.abs(R).max() < 100 * eps * n * scale
        assert np.abs(Z[l] @ Z[l].T - np.eye(n)).max() < 10 * eps * n
    # structure: T[0] quasi-triangular, T[1:] triangular
    assert np.all(np.tril(T[0], -2) == 0)
    for l in range(1, p):
        assert np.all(np.tril(T[l], -1) == 0)
    # eigenvalues vs the explicit product
    prod = np.eye(n)
    for l in range(p):
        prod = prod @ A[l]
    w_ref = np.sort_complex(np.linalg.eigvals(prod))
    w = np.sort_complex(wr + 1j * wi)
    lscale = max(np.abs(w_ref).max(), 1.0)
    assert np.abs(w - w_ref).max() < 1000 * eps * n * lscale


def test_native_hessenberg():
    p, n = 3, 10
    rng = np.random.default_rng(5)
    A = rng.standard_normal((p, n, n))
    H, Q = native.phessenberg_cpu(A)
    eps = np.finfo(np.float64).eps
    for l in range(p):
        R = Q[l] @ H[l] @ Q[(l + 1) % p].T - A[l]
        assert np.abs(R).max() < 100 * eps * n * np.abs(A).max()
    assert np.all(np.tril(H[0], -2) == 0)
    for l in range(1, p):
        assert np.all(np.tril(H[l], -1) == 0)


def test_native_matches_jax_core():
    """Same decomposition contract as the JAX pipeline (not bitwise)."""
    import jax.numpy as jnp
    from periodicschurdecompositions_jax.models.drivers import pschur
    p, n = 3, 12
    rng = np.random.default_rng(9)
    A = rng.standard_normal((p, n, n))
    T, Z, wr, wi = native.pschur_real_cpu(A)
    P = pschur(jnp.asarray(A), "R")
    w_native = np.sort_complex(wr + 1j * wi)
    w_jax = np.sort_complex(np.asarray(P.values))
    assert np.abs(w_native - w_jax).max() < 1e-10 * max(
        1.0, np.abs(w_jax).max())


def test_native_pqz_complex_vs_jitted(rng):
    """The native C++ complex periodic QZ (AED window fast path) must
    match the jitted exact core: same decomposed eigenvalues, valid
    signed reconstruction, unitary Z.  Singular windows decline (None)
    rather than lie."""
    import jax.numpy as jnp

    from periodicschurdecompositions_jax import native
    from periodicschurdecompositions_jax.ops.pqz_complex import (
        pqz_complex_core)
    if not native.available():
        import pytest
        pytest.skip("native host backend unavailable")
    p, w = 3, 8
    S = (True, False, True)
    H = rng.standard_normal((p, w, w)) + 1j * rng.standard_normal((p, w, w))
    H[0] = np.triu(H[0], -1)
    H[1:] = np.triu(H[1:])
    for l in range(1, p):
        d = np.diagonal(H[l]).copy()
        d += np.exp(1j * np.angle(d))
        np.fill_diagonal(H[l], d)
    out = native.pqz_complex_cpu(H, S)
    assert out is not None
    T, Z, al, be, sc = out
    scale = np.abs(H).max()
    for l in range(p):
        Zn = Z[(l + 1) % p]
        X = (Z[l] @ T[l] @ Zn.conj().T) if S[l] else \
            (Zn @ T[l] @ Z[l].conj().T)
        assert np.abs(X - H[l]).max() / scale < 1e-13
        assert np.abs(np.tril(T[l], -1)).max() == 0.0
        assert np.abs(Z[l].conj().T @ Z[l] - np.eye(w)).max() < 1e-13
    Tj, Zj, alj, bej, scj, ok = pqz_complex_core(jnp.asarray(H), S)
    assert bool(ok)
    vn = np.sort_complex(al * 2.0 ** sc.astype(float) / be)
    vj = np.sort_complex(np.asarray(alj) *
                         2.0 ** np.asarray(scj).astype(float) /
                         np.asarray(bej))
    assert np.abs(vn - vj).max() < 1e-12 * max(1.0, np.abs(vj).max())

    # singular direct factor: the fast path must DECLINE, not lie
    H2 = H.copy()
    H2[2, 4, 4] = 0.0
    assert native.pqz_complex_cpu(H2, S) is None
