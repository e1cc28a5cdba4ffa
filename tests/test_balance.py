"""Periodic cycle balancing (utils/balance.py).

The reference leaves `_rebalance!` as a commented-out TODO
(/root/reference/src/ordschur.jl:67); this capability is beyond it.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.utils.balance import balance_pcycle


def _graded_cycle(rng, p, n, grade=6.0):
    """Cycle whose product has row/col norms graded over ~10^grade."""
    A = rng.standard_normal((p, n, n))
    g = np.logspace(0, grade, n)
    for l in range(p):
        A[l] = A[l] * g[None, :] / g[:, None]
    return A


def test_balance_exact_similarity():
    rng = np.random.default_rng(3)
    p, n = 4, 10
    A = _graded_cycle(rng, p, n)
    Ab, D = balance_pcycle(A)
    # D entries are exact powers of two
    m, e = np.frexp(D)
    assert (np.abs(m) == 0.5).all()
    # Ab[l] == diag(1/D[l]) A[l] diag(D[l+1]) EXACTLY (power-of-two scaling)
    for l in range(p):
        ref = (A[l] / D[l][:, None]) * D[(l + 1) % p][None, :]
        assert (Ab[l] == ref).all()
    # the slot-0 products are exactly similar
    P0 = np.linalg.multi_dot(list(A))
    Pb = np.linalg.multi_dot(list(Ab))
    ref = (P0 / D[0][:, None]) * D[0][None, :]
    assert np.allclose(Pb, ref, rtol=1e-13)


def test_balance_equalizes_norms():
    rng = np.random.default_rng(5)
    p, n = 3, 12
    A = _graded_cycle(rng, p, n, grade=8.0)
    Ab, D = balance_pcycle(A)

    def spread(C):
        s = 0.0
        for l in range(p):
            r = np.abs(C[l]).sum(axis=1)
            c = np.abs(C[(l - 1) % p]).sum(axis=0)
            s = max(s, np.max(np.maximum(r, c) / np.minimum(r, c)))
        return s

    assert spread(Ab) < 1e-2 * spread(A)


@pytest.mark.parametrize("p", [1, 4])
def test_balance_improves_graded_eigenvalues(p):
    """pschur on the balanced cycle recovers small eigenvalues of a graded
    product more accurately; values are back-transform-free (similarity)."""
    import periodicschurdecompositions_jax as psd
    rng = np.random.default_rng(11)
    n = 8
    A = _graded_cycle(rng, p, n, grade=7.0)
    Ab, D = balance_pcycle(A)
    Pb = psd.pschur(jnp.asarray(Ab), "R")
    prod = np.linalg.multi_dot(list(A)) if p > 1 else A[0]
    w_ref = np.sort_complex(np.linalg.eigvals(prod))
    w_bal = np.sort_complex(np.asarray(Pb.values))
    scale = np.abs(w_ref).max()
    assert np.abs(w_bal - w_ref).max() < 1e-10 * scale
    # invariant-subspace back-transform: D[0] @ Z[0][:, :1] spans the
    # dominant eigenvector of the ORIGINAL product
    sel = np.zeros(n, bool)
    sel[np.abs(np.asarray(Pb.values)).argmax()] = True
    P2 = psd.ordschur(Pb, sel)
    z = D[0] * np.asarray(P2.Zs[0])[:, 0]
    lam = np.asarray(P2.values)[0]
    if abs(lam.imag) == 0.0:
        r = prod @ z - lam.real * z
        assert np.abs(r).max() < 1e-8 * np.abs(prod @ z).max()
