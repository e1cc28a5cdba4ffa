"""Tests for the arbitrary-precision (mpmath) host path.

Mirrors the reference's BigFloat coverage (test/runtests.jl `BigFloat` in
the eltype matrix, test/generalized.jl:2-40 generic reduction + :69-152
generic core): reconstruction residual, orthonormality, triangularity, and
eigenvalues vs the f64 oracle — all at a working precision far beyond f64,
verifying the path actually computes in extended precision.
"""
import numpy as np
import pytest

from mpmath import mp, mpf

from periodicschurdecompositions_jax.ops.pqz_mp import (
    MpGeneralizedPeriodicSchur, pschur_mp)

DPS = 40
# 40 decimal digits ~ 1e-40 ulp; allow a generous backward-error budget
TOL = mpf("1e-33")


def _rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _check(P: MpGeneralizedPeriodicSchur, A, S, tol=TOL):
    """Triangularity + orthonormality + per-factor reconstruction in mp."""
    A = np.asarray(A)
    p, n, _ = A.shape
    assert P.orientation == "R" and P.schurindex == 0
    with mp.workdps(DPS):
        T = P.Ts
        Z = P.Zs
        for l in range(p):
            # triangularity (exact zeros below the diagonal)
            for i in range(1, n):
                for j in range(i):
                    assert T[l][i, j] == 0, (l, i, j)
            # orthonormality
            for i in range(n):
                for j in range(n):
                    acc = sum(Z[l][i, k] * Z[l][j, k].conjugate()
                              for k in range(n))
                    want = 1 if i == j else 0
                    assert abs(acc - want) < tol
            # reconstruction: S+: Z[l] T[l] Z[l+1]^H = A[l];
            #                 S-: Z[l+1] T[l] Z[l]^H = A[l]
            ln = (l + 1) % p
            Zl, Zr = (Z[l], Z[ln]) if S[l] else (Z[ln], Z[l])
            scale = max(1.0, np.abs(A[l]).max())
            for i in range(n):
                for j in range(n):
                    acc = sum(Zl[i, k] * T[l][k, q] * Zr[j, q].conjugate()
                              for k in range(n) for q in range(n))
                    assert abs(acc - A[l][i, j]) < tol * scale, (l, i, j)


def _check_vals(P, A, S, rtol=1e-10):
    """Eigenvalues vs numpy's eigvals of the explicit signed product."""
    A = np.asarray(A)
    M = np.eye(A.shape[1], dtype=complex)
    for l in range(A.shape[0]):
        M = M @ (A[l] if S[l] else np.linalg.inv(A[l]))
    w = np.linalg.eigvals(M)
    vals = [complex(v) for v in P.values]
    scale = max(np.abs(w).max(), 1e-300)
    rest = list(w)
    for a in vals:  # greedy nearest matching (robust to conjugate-pair ties)
        j = min(range(len(rest)), key=lambda q: abs(a - rest[q]))
        assert abs(a - rest[j]) < rtol * scale, (a, rest[j])
        rest.pop(j)


class TestMpPath:
    @pytest.mark.parametrize("p,n", [(1, 5), (2, 5), (3, 4)])
    def test_complex_psd(self, rng, p, n):
        A = _rand_c(rng, p, n, n)
        P = pschur_mp(A, dps=DPS)
        _check(P, A, (True,) * p)
        _check_vals(P, A, (True,) * p)

    def test_real_input_complexified(self, rng):
        A = rng.standard_normal((3, 5, 5))
        P = pschur_mp(A, dps=DPS, complexify=True)
        _check(P, A, (True,) * 3)
        _check_vals(P, A, (True,) * 3)

    def test_real_input_quasi_triangular(self, rng):
        """Real input keeps REAL arithmetic and a quasi-triangular Schur
        factor (reference generic real BigFloat path,
        test/runtests.jl:89-100)."""
        from mpmath import mpc
        p, n = 3, 6
        A = rng.standard_normal((p, n, n))
        P = pschur_mp(A, dps=DPS)
        T, Z = P.Ts, P.Zs
        with mp.workdps(DPS):
            # REAL entries throughout
            for l in range(p):
                for i in range(n):
                    for j in range(n):
                        assert not isinstance(T[l][i, j], mpc), (l, i, j)
                        assert not isinstance(Z[l][i, j], mpc), (l, i, j)
            # structure: factors 1: triangular; T[0] quasi-triangular with
            # subdiagonal nonzeros exactly under complex pairs
            for l in range(1, p):
                for i in range(1, n):
                    for j in range(i):
                        assert T[l][i, j] == 0
            vals = P.values
            for r in range(n - 1):
                if complex(vals[r]).imag == 0:
                    assert T[0][r + 1, r] == 0
            # orthonormality + reconstruction at working precision
            for l in range(p):
                ln = (l + 1) % p
                scale = max(1.0, np.abs(A[l]).max())
                for i in range(n):
                    for j in range(n):
                        acc = sum(Z[l][i, k] * Z[l][j, k] for k in range(n))
                        assert abs(acc - (1 if i == j else 0)) < TOL
                        acc = sum(Z[l][i, k] * T[l][k, q] * Z[ln][j, q]
                                  for k in range(n) for q in range(n))
                        assert abs(acc - A[l][i, j]) < TOL * scale
        _check_vals(P, A, (True,) * p)

    def test_mixed_signature(self, rng):
        p, n = 4, 5
        S = (True, False, True, False)
        A = _rand_c(rng, p, n, n)
        P = pschur_mp(A, S, dps=DPS)
        _check(P, A, S)
        _check_vals(P, A, S)

    def test_singular_inverted_factor(self, rng):
        """Planted zero diagonal in an inverted factor -> infinite eigval
        (reference planted-hole cases, test/generalized.jl:80-151)."""
        p, n = 3, 5
        S = (True, False, True)
        A = _rand_c(rng, p, n, n)
        # the hole must be EXACTLY singular: at dps=40 a f64-rotated
        # singular matrix has smallest singular value ~1e-16, i.e. a huge
        # but finite eigenvalue.  Plant the zero on a triangular factor
        # directly (the reference's easy-input pattern,
        # test/generalized.jl:80-151).
        A[1] = np.triu(_rand_c(rng, n, n))
        A[1][2, 2] = 0.0
        P = pschur_mp(A, S, dps=DPS)
        _check(P, A, S)
        assert sum(1 for b in P.beta if b == 0) == 1

    def test_singular_direct_factor(self, rng):
        """Zero diagonal in a direct factor -> one zero eigenvalue."""
        p, n = 3, 5
        S = (True, True, False)
        A = _rand_c(rng, p, n, n)
        A[1] = np.triu(_rand_c(rng, n, n))
        A[1][1, 1] = 0.0
        P = pschur_mp(A, S, dps=DPS)
        _check(P, A, S)
        assert min(abs(complex(v)) for v in P.values
                   if not np.isinf(complex(v).real)) < 1e-25

    def test_left_orientation(self, rng):
        """'L' result relabels per rev_alias (reference src/utils.jl:49-85):
        Z'[(j+1)%p]^H A[j] Z'[j] = T'[j] for the left cycle."""
        p, n = 3, 4
        A = _rand_c(rng, p, n, n)
        P = pschur_mp(A, lr="L", dps=DPS)
        assert P.orientation == "L" and P.schurindex == p - 1
        with mp.workdps(DPS):
            T, Z = P.Ts, P.Zs
            for l in range(p):
                ln = (l + 1) % p
                scale = max(1.0, np.abs(A[l]).max())
                for i in range(n):
                    for j in range(n):
                        acc = sum(Z[ln][i, k] * T[l][k, q] *
                                  Z[l][j, q].conjugate()
                                  for k in range(n) for q in range(n))
                        assert abs(acc - A[l][i, j]) < TOL * scale

    def test_precision_scales_with_dps(self, rng):
        """The residual actually tracks the working precision: dps=25 must
        beat f64 by ~10 digits, dps=40 by ~25."""
        A = _rand_c(rng, 2, 4, 4)
        for dps, tol in ((25, mpf("1e-18")), (40, mpf("1e-33"))):
            P = pschur_mp(A, dps=dps)
            with mp.workdps(dps):
                T, Z = P.Ts, P.Zs
                worst = mpf(0)
                for l in range(2):
                    ln = (l + 1) % 2
                    for i in range(4):
                        for j in range(4):
                            acc = sum(Z[l][i, k] * T[l][k, q] *
                                      Z[ln][j, q].conjugate()
                                      for k in range(4) for q in range(4))
                            worst = max(worst, abs(acc - A[l][i, j]))
                assert worst < tol, (dps, worst)

    def test_graded_cycle(self, rng):
        """Exponentially split spectrum (reference expsplit,
        test/testfuncs.jl:412-421): mp handles the grading exactly."""
        p, n = 5, 4
        fac = 10.0
        A = np.stack([np.triu(_rand_c(rng, n, n)) +
                      np.diag(fac ** np.arange(1, n + 1)) for _ in range(p)])
        q, _ = np.linalg.qr(_rand_c(rng, n, n))
        A[0] = A[0] @ q
        A[p - 1] = q.conj().T @ A[p - 1]
        P = pschur_mp(A, dps=DPS)
        _check(P, A, (True,) * p)


def test_object_dtype_input_full_precision(rng):
    """mpf/mpc object arrays decompose WITHOUT an f64 round-trip: the
    residual w.r.t. the exact input tracks dps, not double precision."""
    p, n, dps = 2, 4, 40
    with mp.workdps(dps):
        A = np.empty((p, n, n), dtype=object)
        for l in range(p):
            for i in range(n):
                for j in range(n):
                    # entries NOT representable in f64
                    A[l, i, j] = mp.mpf(int(rng.integers(1, 100))) / 3 + \
                        mp.mpf(int(rng.integers(1, 100))) / 7
        P = pschur_mp(A, dps=dps)
        T, Z = P.Ts, P.Zs
        worst = mp.mpf(0)
        for l in range(p):
            ln = (l + 1) % p
            for i in range(n):
                for j in range(n):
                    acc = sum(Z[l][i, k] * T[l][k, q] *
                              Z[ln][j, q].conjugate()
                              for k in range(n) for q in range(n))
                    worst = max(worst, abs(acc - A[l, i, j]))
        assert worst < mp.mpf("1e-33"), worst


def test_values_precision_and_lr_string_guard(rng):
    """P.values evaluates at the decomposition's own dps regardless of the
    ambient precision, and a string in the S slot is taken as lr."""
    A = rng.standard_normal((2, 4, 4))
    P = pschur_mp(A, dps=40)
    v_ambient = P.values[0]          # ambient mp.dps = 15
    with mp.workdps(40):
        v_40 = P.values[0]
    assert abs(v_ambient - v_40) == 0 or \
        abs(v_ambient - v_40) < mp.mpf("1e-35")
    P2 = pschur_mp(A, "L", dps=25)   # pschur-style positional orientation
    assert P2.orientation == "L"
