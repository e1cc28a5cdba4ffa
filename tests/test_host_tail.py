"""Host-tail finish of the real generalized chunked driver (cfg.host_tail).

Once the active window is small, one native beta=0 window analysis
finishes the leading window; these tests force a small tail and assert
oracle-clean results.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax import native
from periodicschurdecompositions_jax.config import AlgoConfig
from periodicschurdecompositions_jax.ops.hessenberg import (
    phessenberg_signed_core)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native host library unavailable")


def _greedy_match(a, b):
    rest = list(b)
    worst = 0.0
    for x in a:
        j = min(range(len(rest)), key=lambda q: abs(x - rest[q]))
        worst = max(worst, abs(x - rest[j]))
        rest.pop(j)
    return worst


@pytest.mark.parametrize("S,n,tail", [((True, False, True, False), 16, 10),
                                      ((True, False), 12, 6),
                                      ((True, True, False), 14, 14)])
def test_rg_chunked_host_tail(rng, S, n, tail):
    from periodicschurdecompositions_jax.ops.pqz_real import (
        pqz_real_gen_core_chunked)
    p = len(S)
    A = rng.standard_normal((p, n, n))
    for l in range(p):
        A[l] += np.sign(np.linalg.det(A[l])) * 3 * np.eye(n)
    H, Q = phessenberg_signed_core(jnp.asarray(A), S, want_q=True)
    cfg = AlgoConfig(host_tail=tail, aed=False)
    T, Z, alr, ali, be, sc, ok = pqz_real_gen_core_chunked(
        jnp.asarray(H), S, Z=Q, want_z=True, cfg=cfg, chunk_iters=8)
    assert bool(ok)
    T, Z = np.asarray(T), np.asarray(Z)
    for l in range(p):
        ln = (l + 1) % p
        R = (Z[l].T @ A[l] @ Z[ln]) if S[l] else (Z[ln].T @ A[l] @ Z[l])
        assert np.abs(R - T[l]).max() < 1e-11
    vals = (np.asarray(alr) + 1j * np.asarray(ali)) / np.asarray(be) * \
        np.exp2(np.asarray(sc, float))
    M = np.eye(n)
    for l in range(p):
        M = M @ (A[l] if S[l] else np.linalg.inv(A[l]))
    wref = np.linalg.eigvals(M)
    assert _greedy_match(vals, wref) < 1e-9 * np.abs(wref).max()
