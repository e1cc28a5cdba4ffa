"""End-to-end tests for the real generalized periodic QZ core."""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.models.drivers import pschur
from periodicschurdecompositions_jax.diagnostics import check_psd

EPS = np.finfo(np.float64).eps


def _signed_prod(A, S):
    M = np.eye(A.shape[1])
    for l in range(len(S)):
        M = M @ (A[l] if S[l] else np.linalg.inv(A[l]))
    return M


def _match_spectra(w, wx, tol):
    w = sorted(w, key=lambda z: (abs(z), abs(np.angle(z))))
    wx = sorted(wx, key=lambda z: (abs(z), abs(np.angle(z))))
    scale = max(abs(z) for z in w) or 1.0
    for a, b in zip(w, wx):
        err = min(abs(a - b), abs(a - np.conj(b)))
        assert err < tol * scale, (a, b, err / scale)


def run_case(A, S, lr="R", tol_eig=1e5, res_tol=500):
    A = np.asarray(A)
    p, n, _ = A.shape
    P = pschur(jnp.asarray(A), lr, S=S)
    ok, rep = check_psd(P, A, tol=res_tol)
    assert ok, rep
    vals = np.asarray(P.values)
    if lr == "R":
        M = _signed_prod(A, S)
    else:
        M = _signed_prod(A[::-1], tuple(reversed(S)))
    w = np.linalg.eigvals(M)
    _match_spectra(w, vals, tol_eig * EPS * n)
    return P


def _wellcond(rng, p, n):
    """Random cycle with factors shifted to be safely invertible."""
    A = rng.standard_normal((p, n, n))
    for l in range(p):
        A[l] += np.sign(np.linalg.det(A[l])) * 3 * np.eye(n)
    return A


class TestRealGPSD:
    @pytest.mark.parametrize("S", [(True, False), (True, True, False),
                                   (True, False, True, False)])
    def test_mixed_random(self, rng, S):
        p, n = len(S), 7
        A = _wellcond(rng, p, n)
        run_case(A, S)

    def test_all_positive_via_gen(self, rng):
        # signature interface with all-true S routes through the gen core
        p, n = 3, 8
        A = rng.standard_normal((p, n, n))
        run_case(A, (True,) * p, tol_eig=1e6)

    def test_left(self, rng):
        # 'L' reverses the signature, so the LAST entry must be direct
        A = _wellcond(rng, 2, 6)
        run_case(A, (False, True), lr="L")

    def test_complex_pairs_present(self, rng):
        # rotation-heavy cycle guarantees complex pairs -> 2x2 blocks
        th = 0.7
        R = np.eye(6)
        R[0:2, 0:2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        A = np.stack([R @ _wellcond(rng, 1, 6)[0],
                      _wellcond(rng, 1, 6)[0]])
        P = run_case(A, (True, False))
        vals = np.asarray(P.values)
        npairs = (np.abs(vals.imag) > 0).sum()
        T1 = np.asarray(P.T1)
        # quasi-triangular: nonzero subdiagonals exactly at pair tops
        sub = np.abs(np.diag(T1, -1)) > 0
        assert sub.sum() * 2 == npairs

    def test_planted_hole_neg(self, rng):
        # zero diagonal in inverted factor -> infinite eigenvalue
        p, n = 3, 7
        S = (True, True, False)
        A = np.triu(_wellcond(rng, p, n))
        A[0] += np.diag(rng.standard_normal(n - 1), -1)
        for hole in [0, 3, n - 1]:
            Ah = A.copy()
            Ah[2][hole, hole] = 0.0
            P = pschur(jnp.asarray(Ah), "R", S=S)
            ok, rep = check_psd(P, Ah, tol=500)
            assert ok, (hole, rep)
            assert (np.asarray(P.beta) == 0).sum() == 1, hole

    def test_planted_hole_pos(self, rng):
        p, n = 3, 7
        S = (True, True, False)
        A = np.triu(_wellcond(rng, p, n))
        A[0] += np.diag(rng.standard_normal(n - 1), -1)
        for hole in [0, 4, n - 1]:
            Ah = A.copy()
            Ah[1][hole, hole] = 0.0
            P = pschur(jnp.asarray(Ah), "R", S=S)
            ok, rep = check_psd(P, Ah, tol=500)
            assert ok, (hole, rep)
            vals = np.asarray(P.values)
            assert (np.abs(vals) == 0).sum() == 1, (hole, vals)

    def test_n2_pair(self, rng):
        A = _wellcond(rng, 2, 2)
        run_case(A, (True, False))

    def test_gpschur_real_pairs(self, rng):
        from periodicschurdecompositions_jax.models.drivers import gpschur
        As = [_wellcond(rng, 1, 5)[0] for _ in range(2)]
        Bs = [_wellcond(rng, 1, 5)[0] for _ in range(2)]
        G = gpschur(As, Bs)
        M = np.linalg.inv(Bs[1]) @ As[1] @ np.linalg.inv(Bs[0]) @ As[0]
        _match_spectra(np.linalg.eigvals(M), np.asarray(G.values),
                       1e6 * EPS * 5)


def test_aggressive_deflation_planted_hole(rng):
    """aggressive=True fixed thresholds on a planted singular direct factor
    (reference src/rgeneralized.jl:7,54,192-246)."""
    import periodicschurdecompositions_jax as psd
    p, n = 3, 8
    S = (True, True, False)
    A = rng.standard_normal((p, n, n))
    for l in range(p):
        A[l] += 2.0 * np.eye(n)
    P = psd.pschur(jnp.asarray(A), "R", S=S, aggressive=True)
    ok, rep = psd.check_psd(P, jnp.asarray(A))
    assert ok, rep
    P2 = psd.pschur(jnp.asarray(A), "R", S=S, aggressive=False)
    v1 = np.sort(np.abs(np.asarray(P.values)))
    v2 = np.sort(np.abs(np.asarray(P2.values)))
    assert np.allclose(v1, v2, rtol=1e-8)


def test_aggressive_rejects_non_gpsd(rng):
    import pytest as _pytest
    import periodicschurdecompositions_jax as psd
    A = rng.standard_normal((2, 5, 5))
    with _pytest.raises(ValueError):
        psd.pschur(jnp.asarray(A), "R", aggressive=True)


def test_chunked_equivalence(rng):
    """it_cap chunking of the real generalized core must reproduce the
    single-shot run exactly (resume-state round trip of
    ops/pqz_real.pqz_real_gen_core_chunked)."""
    from periodicschurdecompositions_jax.ops.hessenberg import \
        phessenberg_signed_core
    from periodicschurdecompositions_jax.ops.pqz_real import (
        pqz_real_gen_core, pqz_real_gen_core_chunked)
    p, n = 3, 8
    S = (True, False, True)
    A = jnp.asarray(rng.standard_normal((p, n, n)))
    H, Q = phessenberg_signed_core(A, S, want_q=True)
    T1, Z1, alr1, ali1, be1, sc1, ok1 = pqz_real_gen_core(H, S, Z=Q)
    out = pqz_real_gen_core_chunked(H, S, Z=Q, chunk_iters=3)
    T2, Z2, alr2, ali2, be2, sc2, ok2 = out
    assert bool(ok1) and bool(ok2)
    assert np.array_equal(np.asarray(T1), np.asarray(T2))
    assert np.array_equal(np.asarray(Z1), np.asarray(Z2))
    assert np.array_equal(np.asarray(alr1), np.asarray(alr2))
    assert np.array_equal(np.asarray(ali1), np.asarray(ali2))
