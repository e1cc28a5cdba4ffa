"""Reordering tests (mirrors reference test/ordschur.jl strategy)."""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.models.drivers import pschur
from periodicschurdecompositions_jax.models.ordschur import ordschur
from periodicschurdecompositions_jax.diagnostics import check_psd

EPS = np.finfo(np.float64).eps


def _sorted_key(z):
    return (abs(z), abs(np.angle(z)))


def _widen_pairs(values, select):
    """Mirror ordschur's conjugate-pair widening so the expected top group
    has the right width (reference src/rordschur.jl:40-75)."""
    sel = list(bool(x) for x in select)
    vals = np.asarray(values)
    for j, s in enumerate(list(sel)):
        if s and abs(vals[j].imag) > 0:
            for kk in (j - 1, j + 1):
                if 0 <= kk < len(sel) and abs(
                        vals[kk] - np.conj(vals[j])) <= 1e-6 * abs(vals[j]):
                    sel[kk] = True
    return sel


def _check_reorder(A, P, select, S=None, lr="R", tol=1000 * EPS):
    """Reorder; verify decomposition still checks out and the selected
    eigenvalues (as a multiset, widened over conjugate pairs) lead the new
    spectrum.  Default eigenvalue oracle: 1000 eps * scale, matching the
    reference's compare_reigvals (test/testfuncs.jl:28-52)."""
    select_w = _widen_pairs(P.values, select)
    want = np.asarray(P.values)[np.asarray(select_w)]
    P2 = ordschur(P, select)
    ok, rep = check_psd(P2, np.asarray(A), tol=2000.0)
    assert ok, rep
    got = np.asarray(P2.values)[:len(want)]
    ws = sorted(want, key=_sorted_key)
    gs = sorted(got, key=_sorted_key)
    scale = max(abs(z) for z in np.asarray(P.values)) or 1.0
    for a, b in zip(ws, gs):
        err = min(abs(a - b), abs(a - np.conj(b)))
        assert err < tol * scale, (a, b)
    return P2


class TestOrdschurComplex:
    @pytest.mark.parametrize("p", [1, 2, 3])
    def test_random(self, rng, p):
        n = 6
        A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
        # well-separated spectrum by construction (ref test/ordschur.jl:3-55)
        A = A * 0.05
        for l in range(p):
            A[l] += np.diag(2.0 ** np.arange(n))
        P = pschur(jnp.asarray(A), "R")
        select = [False, True, False, True, False, False][:n]
        _check_reorder(A, P, select)

    def test_left_orientation(self, rng):
        p, n = 2, 5
        A = (rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n)))
        A = A * 0.05
        for l in range(p):
            A[l] += np.diag(2.0 ** np.arange(n))
        P = pschur(jnp.asarray(A), "L")
        _check_reorder(A, P, [False, False, True, False, True], lr="L")

    def test_generalized(self, rng):
        p, n = 2, 5
        A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
        A = A * 0.02
        for l in range(p):
            A[l] += np.diag(2.0 ** np.arange(n))
        S = (True, False)
        P = pschur(jnp.asarray(A), "R", S=S)
        _check_reorder(A, P, [False, True, False, False, True], S=S)


class TestOrdschurReal:
    def test_real_singletons(self, rng):
        p, n = 3, 6
        A = rng.standard_normal((p, n, n)) * 0.05
        for l in range(p):
            A[l] += np.diag(2.0 ** np.arange(n))
        P = pschur(jnp.asarray(A), "R")
        assert np.abs(np.asarray(P.values).imag).max() < 1e-8
        _check_reorder(A, P, [False, False, True, False, True, False])

    def test_real_with_pairs(self, rng):
        # plant a rotation block -> conjugate pair somewhere in the spectrum
        p, n = 2, 6
        th = 0.8
        D = np.eye(n) * 0.0 + np.diag([8.0, 4.0, 2.0, 1.0, 0.5, 0.25])
        D[2:4, 2:4] = 2.0 * np.array([[np.cos(th), -np.sin(th)],
                                      [np.sin(th), np.cos(th)]])
        q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
        q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = np.stack([q1 @ D @ q2.T, q2 @ np.eye(n) @ q1.T])
        P = pschur(jnp.asarray(A), "R")
        vals = np.asarray(P.values)
        # select the complex pair (wherever it landed)
        sel = [abs(v.imag) > 1e-8 for v in vals]
        assert sum(sel) == 2
        P2 = _check_reorder(A, P, sel)
        assert abs(np.asarray(P2.values)[0].imag) > 1e-8

    def test_select_widening(self, rng):
        # selecting one half of a pair must bring the whole pair
        p, n = 2, 4
        th = 0.9
        D = np.diag([4.0, 2.0, 1.0, 0.5])
        D[1:3, 1:3] = 1.5 * np.array([[np.cos(th), -np.sin(th)],
                                      [np.sin(th), np.cos(th)]])
        q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = np.stack([q1 @ D, q1.T])
        P = pschur(jnp.asarray(A), "R")
        vals = np.asarray(P.values)
        ipair = int(np.argmax(np.abs(vals.imag) > 1e-8))
        sel = [False] * n
        sel[ipair] = True
        P2 = ordschur(P, sel)
        ok, rep = check_psd(P2, A, tol=2000.0)
        assert ok, rep
        v2 = np.asarray(P2.values)
        assert abs(v2[0].imag) > 1e-8 and abs(v2[1].imag) > 1e-8


# ---------------------------------------------------------------------------
# Isolated-L3 fixture (reference mkrps, test/ordschur.jl:62-125): plant
# conjugate pairs directly in (T, Z) space so ordschur is tested WITHOUT
# running pschur — a reorder bug cannot hide behind core behavior.


def mkrps(rng, n, p, jcs, nnfac=1e-2):
    """Synthetic decomposition with conjugate pairs at 0-based positions
    ``jcs`` (each j in jcs pairs rows (j-1, j)).  Returns (P, A) in right
    orientation, schurindex 0."""
    from periodicschurdecompositions_jax.types import PeriodicSchur
    T = np.zeros((p, n, n))
    T[0] = np.triu(nnfac * rng.random((n, n)))
    for l in range(1, p):
        T[l] = np.triu(nnfac * rng.random((n, n)))
    lam = np.zeros(n, complex)
    jj = 0
    mu = 1.0
    for j in range(n):
        if j in jcs:
            T[0][j, j - 1] = mu
            T[0][j - 1, j] = -mu
            lam[j] = 2.0 ** (2 * jj) * (1 - 1j)
            lam[j - 1] = 2.0 ** (2 * jj) * (1 + 1j)
            for l in range(1, p):
                # eigvals are very sensitive to these entries (ref :80)
                T[l][j - 1, j] = 0.0
        else:
            jj += 1
            mu = 2.0 ** (2 * jj / p)
            lam[j] = 2.0 ** (2 * jj)
        T[0][j, j] = mu
        for l in range(1, p):
            T[l][j, j] = mu
    Z = []
    for l in range(p):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Z.append(q)
    Z = np.stack(Z)
    A = np.stack([Z[l] @ T[l] @ Z[(l + 1) % p].T for l in range(p)])
    P = PeriodicSchur(Ts=jnp.asarray(T), Zs=jnp.asarray(Z),
                      values=jnp.asarray(lam), orientation="R", schurindex=0)
    return P, A


class TestMkrpsFixture:
    def test_fixture_valid(self, rng):
        P, A = mkrps(rng, 8, 3, jcs=(3, 7))
        ok, rep = check_psd(P, A, tol=2000.0)
        assert ok, rep

    @pytest.mark.parametrize("jcs,select", [
        ((3, 7), [False, False, True, True, False, False, False, False]),
        ((3, 7), [False, False, False, False, False, False, True, True]),
        ((3,), [False, False, False, True, False, True, False, False]),
        ((5,), [False, False, False, False, True, False, False, True]),
    ])
    def test_reorder_planted_pairs(self, rng, jcs, select):
        P, A = mkrps(rng, 8, 3, jcs=jcs)
        _check_reorder(A, P, select)

    def test_pair_widening(self, rng):
        """Selecting half a conjugate pair must widen over the pair
        (reference src/rordschur.jl:40-75)."""
        P, A = mkrps(rng, 8, 2, jcs=(3,))
        select = [False, False, False, True, False, False, False, False]
        P2 = ordschur(P, select)
        ok, rep = check_psd(P2, A, tol=2000.0)
        assert ok, rep
        top = np.asarray(P2.values)[:2]
        assert abs(top[0] - np.conj(top[1])) < 1e-6 * abs(top[0])

    def test_single_factor(self, rng):
        P, A = mkrps(rng, 6, 1, jcs=(3,))
        _check_reorder(A, P, [False, False, True, True, False, False])

    @pytest.mark.parametrize("shift", [1, 2])
    def test_arbitrary_schurindex(self, rng, shift):
        """Any schurindex is normalized via cyclic relabeling (reference
        handles arbitrary indices, src/utils.jl:6-85)."""
        from periodicschurdecompositions_jax.utils.circshift import \
            circshift_psd
        P, A = mkrps(rng, 8, 3, jcs=(3,))
        Ps = circshift_psd(P, shift)
        assert Ps.schurindex == shift
        As = np.roll(A, shift, axis=0)
        ok, rep = check_psd(Ps, As, tol=2000.0)
        assert ok, rep
        P2 = _check_reorder(As, Ps, [False, False, False, True, False, True,
                                     False, False])
        assert P2.schurindex == shift

    def test_ill_conditioned_swap_raises(self, rng):
        """A swap across (numerically) identical eigenvalues with strong
        coupling must be rejected, not silently corrupted (reference
        src/sylswap.jl weak/strong tests -> IllConditionedException)."""
        from periodicschurdecompositions_jax.types import (
            IllConditionedException, PeriodicSchur)
        n, p = 4, 2
        T = np.zeros((p, n, n))
        for l in range(p):
            T[l] = np.eye(n)
        # identical adjacent eigenvalues with O(1) coupling: the periodic
        # Sylvester system is singular -> stability tests must reject
        T[0][1, 2] = 1.0
        Z = np.stack([np.eye(n) for _ in range(p)])
        A = np.stack([Z[l] @ T[l] @ Z[(l + 1) % p].T for l in range(p)])
        lam = np.ones(n, complex)
        P = PeriodicSchur(Ts=jnp.asarray(T), Zs=jnp.asarray(Z),
                          values=jnp.asarray(lam), orientation="R",
                          schurindex=0)
        with pytest.raises(IllConditionedException):
            ordschur(P, [False, False, True, False])


# ---------------------------------------------------------------------------
# Real-signature generalized reordering (reference test/ordschur.jl:166-273):
# synthetic GENERALIZED decomposition with mixed signatures and planted
# conjugate pairs, exercising the inverted-factor swap branches
# (swapadj1x1 / swapadjqr with S[l] False) and _update_values' 2x2 re-solve.


def mkrgps(rng, n, p, jcs, S, nnfac=1e-2):
    """Synthetic real generalized decomposition (right orientation,
    schurindex 0) with signature ``S`` and conjugate pairs at 0-based
    positions ``jcs`` (each j pairs rows (j-1, j)).  Inverted factors get
    diagonal 1/mu so every factor contributes mu to the signed product
    (same grading as mkrps).  Returns (P, A)."""
    from periodicschurdecompositions_jax.types import \
        GeneralizedPeriodicSchur
    from periodicschurdecompositions_jax.models.ordschur import \
        _update_values
    T = np.zeros((p, n, n))
    for l in range(p):
        T[l] = np.triu(nnfac * rng.random((n, n)))
    jj = 0
    mu = 1.0
    for j in range(n):
        if j in jcs:
            T[0][j, j - 1] = mu
            T[0][j - 1, j] = -mu
            for l in range(1, p):
                T[l][j - 1, j] = 0.0
        else:
            jj += 1
            mu = 2.0 ** (2 * jj / p)
        T[0][j, j] = mu
        for l in range(1, p):
            T[l][j, j] = mu if S[l] else 1.0 / mu
    Z = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0]
                  for _ in range(p)])
    A = np.empty_like(T)
    for l in range(p):
        ln = (l + 1) % p
        if S[l]:
            A[l] = Z[l] @ T[l] @ Z[ln].T
        else:
            A[l] = Z[ln] @ T[l] @ Z[l].T
    alpha, beta, scale = _update_values([T[l] for l in range(p)],
                                        tuple(S))
    P = GeneralizedPeriodicSchur(
        S=tuple(bool(s) for s in S), schurindex=0, Ts=jnp.asarray(T),
        Zs=jnp.asarray(Z), alpha=jnp.asarray(alpha),
        beta=jnp.asarray(beta), alphascale=jnp.asarray(scale, jnp.int32),
        orientation="R")
    return P, A


class TestOrdschurRealGeneralized:
    def test_fixture_valid(self, rng):
        P, A = mkrgps(rng, 8, 3, jcs=(3, 7), S=(True, False, True))
        ok, rep = check_psd(P, A, tol=2000.0)
        assert ok, rep

    @pytest.mark.parametrize("S", [
        (True, False, True), (True, True, False), (True, False, False)])
    @pytest.mark.parametrize("jcs,select", [
        ((3,), [False, False, True, True, False, False, False, False]),
        ((5,), [False, False, False, False, True, False, False, True]),
        ((3, 7), [False, False, False, False, False, False, True, True]),
    ])
    def test_reorder_planted_pairs(self, rng, S, jcs, select):
        P, A = mkrgps(rng, 8, 3, jcs=jcs, S=S)
        _check_reorder(A, P, select)

    def test_singletons_inverted(self, rng):
        """1x1 moves across inverted factors (swapadj1x1 S-branches)."""
        P, A = mkrgps(rng, 6, 2, jcs=(), S=(True, False))
        _check_reorder(A, P, [False, False, True, False, True, False])

    def test_pair_widening_generalized(self, rng):
        P, A = mkrgps(rng, 8, 2, jcs=(3,), S=(True, False))
        select = [False, False, False, True, False, False, False, False]
        P2 = ordschur(P, select)
        ok, rep = check_psd(P2, A, tol=2000.0)
        assert ok, rep
        top = np.asarray(P2.values)[:2]
        assert abs(top[0] - np.conj(top[1])) < 1e-6 * abs(top[0])


class TestIterative2x2:
    """Optional MB03BB-style iterative 2x2 eigensolver
    (AlgoConfig.iterative_2x2; reference src/rpschur2x2.jl:9-235)."""

    @pytest.mark.parametrize("S", [(True,) * 4, (True, False, True, False)])
    def test_matches_oneshot(self, rng, S):
        from periodicschurdecompositions_jax.ops.reorder_np import \
            rpeigvals2x2_np
        from periodicschurdecompositions_jax.models.ordschur import \
            _eig2x2_prod_np
        for trial in range(8):
            W = [np.triu(rng.standard_normal((2, 2))) +
                 np.diag(0.5 + rng.random(2)) for _ in range(len(S))]
            # make the leading block full (rotation-like for pairs)
            W[0][1, 0] = rng.standard_normal()
            (w1, s1), (w2, s2), b1, okc = rpeigvals2x2_np(W, S)
            assert okc
            (v1, t1), (v2, t2), b2 = _eig2x2_prod_np(
                [w.astype(float) for w in W], S)
            got = sorted([w1 * 2.0 ** s1, w2 * 2.0 ** s2],
                         key=lambda z: (abs(z), z.imag))
            want = sorted([v1 * 2.0 ** t1, v2 * 2.0 ** t2],
                          key=lambda z: (abs(z), z.imag))
            for g, w in zip(got, want):
                err = min(abs(g - w), abs(g - np.conj(w)))
                assert err < 1e-10 * max(abs(w), 1e-30), (trial, got, want)

    def test_ordschur_with_iterative_cfg(self, rng):
        from periodicschurdecompositions_jax.config import AlgoConfig
        P, A = mkrps(rng, 8, 3, jcs=(3,))
        select = [False, False, False, True, False, True, False, False]
        P2 = ordschur(P, select, cfg=AlgoConfig(iterative_2x2=True))
        ok, rep = check_psd(P2, A, tol=2000.0)
        assert ok, rep
        P3 = ordschur(P, select)
        v2 = np.sort_complex(np.asarray(P2.values))
        v3 = np.sort_complex(np.asarray(P3.values))
        scale = np.abs(v3).max()
        assert np.abs(v2 - v3).max() < 1e-10 * scale


def test_rpeigvals2x2_complex_inverted(rng):
    """Iterative 2x2 eigensolver on COMPLEX cycles with inverted factors:
    the RQ stage carried a spurious conjugation that silently corrupted
    the eigenvalues (converged=True with O(1) errors)."""
    from periodicschurdecompositions_jax.ops.reorder_np import (
        rpeigvals2x2_np)
    S = (True, False, True)
    for trial in range(10):
        W = rng.standard_normal((3, 2, 2)) + \
            1j * rng.standard_normal((3, 2, 2))
        (w1, s1), (w2, s2), beta, convd = rpeigvals2x2_np(W, S)
        if not convd:
            continue
        M = np.eye(2, dtype=complex)
        for l in range(3):
            M = M @ (W[l] if S[l] else np.linalg.inv(W[l]))
        w = list(np.linalg.eigvals(M))
        scale = max(abs(z) for z in w)
        for v in (w1 * 2.0 ** s1, w2 * 2.0 ** s2):
            j = min(range(len(w)), key=lambda q: abs(v - w[q]))
            assert abs(v - w[j]) < 1e-8 * scale, (trial, v, w[j])
            w.pop(j)


def test_ill_conditioned_swap_rejects_not_corrupts(rng):
    """A swap whose Sylvester solution overflows must be REJECTED (False /
    IllConditionedException), never accepted with NaN transforms and never
    escape as a raw OverflowError."""
    from periodicschurdecompositions_jax.ops.reorder_np import (
        swapadj1x1)
    from periodicschurdecompositions_jax.types import (
        IllConditionedException)
    k, n = 3, 4
    T = [np.triu(rng.standard_normal((n, n))) for _ in range(k)]
    for l in range(k):  # coincident eigenvalues + enormous coupling
        T[l][1, 1] = 1.0
        T[l][2, 2] = 1.0
        T[l][1, 2] = 1e290
    Z = [np.eye(n) for _ in range(k)]
    T0 = [t.copy() for t in T]
    try:
        ok = swapadj1x1(T, Z, (True,) * k, 1)
    except IllConditionedException:
        ok = False
    if ok:
        for l in range(k):
            assert np.all(np.isfinite(T[l])), "accepted swap wrote NaN/inf"
    else:
        for l in range(k):
            assert np.array_equal(T[l], T0[l]), "rejected swap mutated T"
