"""Periodic Hessenberg reduction tests (mirrors reference test/runtests.jl:14-50)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.ops.hessenberg import phessenberg_core


def _random_cycle(rng, p, n, dtype):
    A = rng.standard_normal((p, n, n))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((p, n, n))
    return jnp.asarray(A.astype(dtype))


@pytest.mark.parametrize("p", [1, 2, 5])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_phessenberg_reconstruct(rng, p, dtype):
    n = 9
    A = _random_cycle(rng, p, n, dtype)
    H, Q = jax.jit(phessenberg_core, static_argnames="want_q")(A)
    H = np.asarray(H)
    Q = np.asarray(Q)
    eps = np.finfo(np.float64).eps
    # structure
    assert np.abs(np.tril(H[0], -2)).max() == 0.0
    for j in range(1, p):
        assert np.abs(np.tril(H[j], -1)).max() == 0.0
    # orthogonality
    for j in range(p):
        assert np.abs(Q[j] @ Q[j].conj().T - np.eye(n)).max() < 50 * eps * n
    # reconstruction: A[j] = Q[j] H[j] Q[j+1]^H
    for j in range(p):
        Ax = Q[j] @ H[j] @ Q[(j + 1) % p].conj().T
        assert np.abs(Ax - np.asarray(A[j])).max() < 100 * eps * n * np.abs(
            np.asarray(A[j])).max()
    # eigenvalues of the product are preserved
    prod = np.linalg.multi_dot(list(np.asarray(A))) if p > 1 else np.asarray(A[0])
    prodH = np.linalg.multi_dot(list(H)) if p > 1 else H[0]
    w0 = np.sort_complex(np.linalg.eigvals(prod))
    w1 = np.sort_complex(np.linalg.eigvals(prodH))
    assert np.abs(w0 - w1).max() < 1e-9 * max(1, np.abs(w0).max())


def test_phessenberg_no_q(rng):
    A = _random_cycle(rng, 3, 6, np.float64)
    H, Q = phessenberg_core(A, want_q=False)
    assert Q is None
    H2, _ = phessenberg_core(A, want_q=True)
    assert np.allclose(np.asarray(H), np.asarray(H2))


def test_phessenberg_tiny(rng):
    A = _random_cycle(rng, 3, 1, np.float64)
    H, Q = phessenberg_core(A)
    assert np.allclose(np.asarray(H), np.asarray(A))
