"""Native C++ real generalized periodic QZ vs the jitted exact core.

The native window solver (native/pschur_cpu.cpp::pqz_real_gen_cpu) powers
the rg AED window analyses (ops/aed.py::_window_rgpsd); it must reproduce
the jitted core's decomposition contract: reconstruction ~1e-14,
orthogonality, quasi-triangular structure, and matching eigenvalues
(reference behavior: /root/reference/src/rgeneralized.jl:49-1083).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax import native
from periodicschurdecompositions_jax.ops.hessenberg import (
    phessenberg_signed_core)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native host library unavailable")


def _mk_window(p, n, S, seed, diag_boost=3.0):
    r = np.random.default_rng(seed)
    A = r.standard_normal((p, n, n))
    for l in range(p):
        A[l] += np.sign(np.linalg.det(A[l])) * diag_boost * np.eye(n)
    H, _ = phessenberg_signed_core(jnp.asarray(A), S, want_q=True)
    return np.asarray(H)


def _check_decomp(Hn, S, out):
    T, Z, alr, ali, be, sc = out
    p, n, _ = Hn.shape
    scale = np.abs(Hn).max()
    for l in range(p):
        ln = (l + 1) % p
        R = (Z[l].T @ Hn[l] @ Z[ln]) if S[l] else (Z[ln].T @ Hn[l] @ Z[l])
        assert np.abs(R - T[l]).max() / scale < 1e-12
        assert np.abs(Z[l].T @ Z[l] - np.eye(n)).max() < 1e-12
    # structure: triangular factors clean; H[0] quasi-triangular with
    # nonzero subdiagonals only under complex pairs
    for l in range(1, p):
        assert np.abs(np.tril(T[l], -1)).max() == 0.0
    sub = np.diag(T[0], -1)
    for r in range(n - 1):
        if ali[r] == 0.0:
            assert sub[r] == 0.0


@pytest.mark.parametrize("p,n,S,seed", [
    (2, 8, (True, False), 1),
    (4, 12, (True, False, True, False), 2),
    (4, 16, (True, True, False, True), 3),
    (3, 20, (True, False, False), 5),
])
def test_native_rg_decomposition(p, n, S, seed):
    Hn = _mk_window(p, n, S, seed)
    out = native.pqz_real_gen_cpu(Hn, S)
    assert out is not None
    _check_decomp(Hn, S, out)


def test_native_rg_eigvals_vs_jitted():
    from periodicschurdecompositions_jax.ops.pqz_real import (
        pqz_real_gen_core)
    p, n, S = 4, 12, (True, False, True, False)
    Hn = _mk_window(p, n, S, 17)
    out = native.pqz_real_gen_cpu(Hn, S)
    assert out is not None
    T, Z, alr, ali, be, sc = out
    Tj, Zj, arj, aij, bej, scj, ok = pqz_real_gen_core(
        jnp.asarray(Hn), S, want_z=True)
    assert bool(ok)
    ev_n = np.sort_complex((alr + 1j * ali) * np.exp2(sc.astype(float)))
    ev_j = np.sort_complex(
        (np.asarray(arj) + 1j * np.asarray(aij)) *
        np.exp2(np.asarray(scj, float)))
    assert np.abs(ev_n - ev_j).max() < 1e-12 * np.abs(ev_j).max()


def test_native_rg_declines_singular_window():
    # a planted zero diagonal in an inverted factor needs the singular-
    # factor machinery: the native core must decline (None), mirroring
    # pqz_complex_cpu's rc=2 contract
    p, n, S = 3, 10, (True, False, True)
    Hn = _mk_window(p, n, S, 23).copy()
    Hn[1, 4, 4] = 0.0
    assert native.pqz_real_gen_cpu(Hn, S) is None


def test_window_rgpsd_native_route():
    # the AED plumbing returns the native result for a clean window
    from periodicschurdecompositions_jax.ops.aed import _window_rgpsd
    p, n, S = 4, 16, (True, False, True, False)
    Hn = _mk_window(p, n, S, 29)
    out = _window_rgpsd(Hn, S)
    assert out is not None
    _check_decomp(Hn, S, out)
