"""Signed Hessenberg-triangular reduction tests (mirrors test/generalized.jl:2-40)."""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.ops.hessenberg import phessenberg_signed_core

EPS = np.finfo(np.float64).eps


@pytest.mark.parametrize("S", [(True, False), (True, False, True, False),
                               (True, True, False), (True,),
                               (True, False, False, True),
                               (True, False, True, False, True, False)])
@pytest.mark.parametrize("cplx", [False, True])
def test_signed_hess(rng, S, cplx):
    p, n = len(S), 8
    A = rng.standard_normal((p, n, n))
    if cplx:
        A = A + 1j * rng.standard_normal((p, n, n))
    H, Q = phessenberg_signed_core(jnp.asarray(A), S)
    H, Q = np.asarray(H), np.asarray(Q)
    assert np.abs(np.tril(H[0], -2)).max() == 0.0
    for l in range(1, p):
        assert np.abs(np.tril(H[l], -1)).max() == 0.0
    for l in range(p):
        assert np.abs(Q[l] @ Q[l].conj().T - np.eye(n)).max() < 100 * EPS * n
        ln = (l + 1) % p
        if S[l]:
            Ax = Q[l] @ H[l] @ Q[ln].conj().T
        else:
            Ax = Q[ln] @ H[l] @ Q[l].conj().T
        assert np.abs(Ax - A[l]).max() < 200 * EPS * n * np.abs(A[l]).max(), f"factor {l}"
