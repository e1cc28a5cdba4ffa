"""The extra_rq subdiagonal-repair stage (reference :637-652).

The repair branch fires when the PRODUCT subdiagonal is negligible while
H0's own subdiagonal entry is not (a tiny triangular diagonal kills the
product coupling); with ``extra_rq`` the leftover H[p-1] subdiagonal is
annihilated by a proper reflector instead of MB03WD's force-zero.  Both
settings must produce an oracle-clean decomposition.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.config import AlgoConfig
from periodicschurdecompositions_jax.ops.pqr_real import pqr_real_core


def _easy_input(rng, p, n, k, tiny):
    """Hessenberg + triangular cycle with a tiny diagonal H[1][k, k]:
    the product subdiagonal at k+1 is negligible, H0's is O(1) -> the
    repair chain fires (reference :589-665)."""
    H = np.zeros((p, n, n))
    H[0] = np.triu(rng.standard_normal((n, n)), -1)
    for l in range(1, p):
        H[l] = np.triu(rng.standard_normal((n, n)))
        np.fill_diagonal(H[l], 1.0 + rng.random(n))
    H[1][k, k] = tiny
    return H


@pytest.mark.parametrize("p,n,k,tiny", [(3, 10, 4, 1e-22), (2, 9, 1, 1e-18),
                                        (5, 12, 8, 1e-20)])
@pytest.mark.parametrize("extra_rq", [False, True])
def test_extra_rq_f64_core(rng, extra_rq, p, n, k, tiny):
    H = _easy_input(rng, p, n, k, tiny)
    cfg = AlgoConfig(extra_rq=extra_rq)
    T, Z, wr, wi, ok = pqr_real_core(jnp.asarray(H), want_z=True, cfg=cfg)
    assert bool(ok)
    T, Z = np.asarray(T), np.asarray(Z)
    scale = np.abs(H).max()
    for l in range(p):
        r = np.abs(Z[l].T @ H[l] @ Z[(l + 1) % p] - T[l]).max()
        assert r / scale < 1e-12, (l, r)
        assert np.abs(Z[l].T @ Z[l] - np.eye(n)).max() < 1e-12
