"""ops/smallschur: fixed-budget eigenvalues of small Hessenberg matrices
(the shift engine for a small-bulge multishift sweep)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from periodicschurdecompositions_jax.ops.smallschur import hess_eigs_small


@pytest.mark.parametrize("M", [2, 4, 6, 8])
def test_hess_eigs_small_random(M):
    rng = np.random.default_rng(7)
    f = jax.jit(hess_eigs_small)
    for trial in range(24):
        W = np.triu(rng.standard_normal((M, M)), -1)
        if trial % 4 == 1 and M > 2:
            W[M - 1, M - 2] = 0.0      # pre-split bottom
        if trial % 4 == 2:
            W *= 1e3                    # scale invariance
        wr, wi = f(jnp.asarray(W))
        got = np.sort_complex(np.asarray(wr) + 1j * np.asarray(wi))
        ref = np.sort_complex(np.linalg.eigvals(W))
        scale = max(np.max(np.abs(ref)), 1e-300)
        assert np.max(np.abs(got - ref)) / scale < 1e-6, (M, trial)


def test_hess_eigs_small_conjugate_order():
    """Complex eigenvalues come out as adjacent conjugate pairs occupying
    their block's diagonal positions."""
    rng = np.random.default_rng(11)
    for _ in range(10):
        W = np.triu(rng.standard_normal((6, 6)), -1)
        wr, wi = hess_eigs_small(jnp.asarray(W))
        wr, wi = np.asarray(wr), np.asarray(wi)
        j = 0
        while j < 6:
            if wi[j] != 0:
                assert j + 1 < 6
                assert wi[j + 1] == pytest.approx(-wi[j], rel=1e-12)
                assert wr[j + 1] == pytest.approx(wr[j], rel=1e-12)
                j += 2
            else:
                j += 1


def test_hess_eigs_small_m1_and_triangular():
    wr, wi = hess_eigs_small(jnp.asarray([[3.25]]))
    assert float(wr[0]) == 3.25 and float(wi[0]) == 0.0
    W = np.triu(np.random.default_rng(0).standard_normal((5, 5)))
    wr, wi = hess_eigs_small(jnp.asarray(W))
    assert np.allclose(np.sort(np.asarray(wr)), np.sort(np.diag(W)),
                       atol=1e-10)
    assert np.all(np.asarray(wi) == 0.0)
