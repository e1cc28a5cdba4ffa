"""Eigenvector tests (mirrors reference test/vectors.jl + ev_check)."""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.models.drivers import pschur
from periodicschurdecompositions_jax.models.vectors import eigvecs


def ev_check(As, Vs, lams, left, tol=1e-7):
    """A[l] V[l] = mu V[(l+1)%p] with mu = lam^(1/p) (reference
    test/testfuncs.jl:424-436, left orientation)."""
    p = len(As)
    nev = Vs[0].shape[1]
    for ki in range(nev):
        mu = complex(lams[ki]) ** (1.0 / p)
        for l in range(p):
            if left:
                lhs = As[l] @ np.asarray(Vs[l])[:, ki]
                rhs = mu * np.asarray(Vs[(l + 1) % p])[:, ki]
            else:
                lhs = As[l] @ np.asarray(Vs[(l + 1) % p])[:, ki]
                rhs = mu * np.asarray(Vs[l])[:, ki]
            ref = abs(mu) * np.linalg.norm(rhs) + 1e-30
            assert np.linalg.norm(lhs - rhs) < tol * max(ref, 1), (ki, l)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("which", ["largest", "smallest"])
def test_eigvecs_left(rng, cplx, which):
    p, n = 3, 6
    A = rng.standard_normal((p, n, n)) * 0.05
    if cplx:
        A = A + 1j * rng.standard_normal((p, n, n)) * 0.05
    for l in range(p):
        A[l] += np.diag(2.0 ** np.arange(n))
    P = pschur(jnp.asarray(A), "L")
    vals = np.asarray(P.values)
    order = np.argsort(np.abs(vals))
    pick = order[-2:] if which == "largest" else order[:2]
    select = [j in pick for j in range(n)]
    Vs = eigvecs(P, select)
    assert len(Vs) == p and Vs[0].shape == (n, 2)
    ev_check(A, Vs, np.asarray([v for j, v in enumerate(vals) if select[j]]),
             left=True)


def test_eigvecs_pair(rng):
    # real cycle with a conjugate pair: 2x2 cyclic solve path
    p, n = 2, 4
    th = 0.9
    D = np.diag([4.0, 2.0, 1.0, 0.5])
    D[1:3, 1:3] = 1.5 * np.array([[np.cos(th), -np.sin(th)],
                                  [np.sin(th), np.cos(th)]])
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = np.stack([q1 @ D, q1.T])
    P = pschur(jnp.asarray(A), "L")
    vals = np.asarray(P.values)
    sel = [abs(v.imag) > 1e-8 for v in vals]
    assert sum(sel) == 2
    Vs = eigvecs(P, sel)
    lams = np.asarray([v for j, v in enumerate(vals) if sel[j]])
    ev_check(A, Vs, lams, left=True, tol=1e-6)


def test_eigvecs_right(rng):
    p, n = 2, 5
    A = rng.standard_normal((p, n, n)) * 0.05
    for l in range(p):
        A[l] += np.diag(2.0 ** np.arange(n))
    P = pschur(jnp.asarray(A), "R")
    vals = np.asarray(P.values)
    j = int(np.argmax(np.abs(vals)))
    sel = [jj == j for jj in range(n)]
    Vs = eigvecs(P, sel)
    v = np.asarray(Vs[0])[:, 0]
    lhs = A[0] @ A[1] @ v
    assert np.linalg.norm(lhs - vals[j] * v) < 1e-7 * abs(vals[j])


def test_eigvecs_unshifted(rng):
    p, n = 3, 5
    A = rng.standard_normal((p, n, n)) * 0.05
    for l in range(p):
        A[l] += np.diag(2.0 ** np.arange(n))
    P = pschur(jnp.asarray(A), "L")
    vals = np.asarray(P.values)
    j = int(np.argmax(np.abs(vals)))
    Vs = eigvecs(P, [jj == j for jj in range(n)], shifted=False)
    assert len(Vs) == 1
    v = np.asarray(Vs[0])[:, 0]
    lhs = A[2] @ A[1] @ A[0] @ v
    assert np.linalg.norm(lhs - vals[j] * v) < 1e-7 * abs(vals[j])


def test_graded_cycle_reorder_eigvecs(rng):
    """Exponentially-split p=20 cycle (reference testfuncs.jl:412-421)
    through ordschur + eigvecs: exercises the scaled 2x2 product eigenvalue
    path on severely graded data."""
    from periodicschurdecompositions_jax.models.ordschur import ordschur
    from periodicschurdecompositions_jax.diagnostics import check_psd
    fac = 0.1
    p = 20
    A1 = np.array([[9, 4, 1, 4, 3, 4], [6, 8, 2, 4, 0, 2],
                   [0, 7, 4, 4, 6, 6], [0, 0, 8, 4, 6, 7],
                   [0, 0, 0, 8, 9, 3], [0, 0, 0, 0, 5, 0]], float)
    Aj = np.diag([fac, fac ** 2, fac ** 3, 1, 1, 1])
    A = np.stack([A1] + [Aj] * (p - 1))
    P = pschur(jnp.asarray(A), "L")
    lam = np.asarray(P.values)
    # reorder the conjugate pair (the only complex eigenvalues) to the top
    pair = np.where(np.abs(lam.imag) > 0)[0]
    assert len(pair) == 2
    select = [bool(i in pair) for i in range(6)]
    P2 = ordschur(P, select)
    ok, rep = check_psd(P2, A, tol=5e4)  # graded: growth ~ |T| ratios
    assert ok, rep
    lam2 = np.asarray(P2.values)
    assert np.abs(lam2[:2].imag).min() > 0  # the pair leads
    # asymptotic pair value (reference runtests.jl:68-87 contract)
    ref_pair = -1.31418 + 3.51424j
    match = min(abs(lam2[0] - ref_pair), abs(lam2[0] - np.conj(ref_pair)))
    assert match < 1e-3 * abs(ref_pair)

    # eigenvectors of the dominant eigenvalue (ev_check,
    # reference testfuncs.jl:424-436; left orientation)
    idx = int(np.argmax(np.abs(lam)))
    sel_v = [i == idx for i in range(6)]
    Vs = eigvecs(P, sel_v, shifted=True)
    ev_check(A, Vs, np.asarray([lam[idx]]), left=True, tol=1e-6)


def test_eigvecs_partial(rng):
    """PartialPeriodicSchur dispatch + Ritz-basis lift (reference
    src/krylov.jl:996-1022) — previously untested."""
    from periodicschurdecompositions_jax.models.krylov import (
        partial_pschur)
    p, n = 2, 24
    A = rng.standard_normal((p, n, n))
    PS, hist = partial_pschur(A, nev=3, which="LM", seed=4)
    assert hist.nconverged >= 2
    nv = min(2, hist.nconverged)
    select = [True] * nv + [False] * (len(np.asarray(PS.values)) - nv)
    Vs = eigvecs(PS, select)
    lams = np.asarray(PS.values)[:nv]
    # left orientation (the Krylov driver's only mode)
    ev_check(A, Vs, lams, left=True, tol=1e-5)


def test_eigvecs_unsplit_real_block(rng):
    """An UNSPLIT 2x2 block with two real (distinct) product eigenvalues:
    structural widening + the separate per-eigenvalue 2x2 solves (the old
    imag-based gate returned non-eigenvectors silently)."""
    from periodicschurdecompositions_jax.types import PeriodicSchur
    p, n = 2, 5
    T = np.stack([np.triu(0.05 * rng.random((n, n))) + np.diag(
        [1.0, 1.0, 3.0, 5.0, 7.0]) for _ in range(p)])
    # leading 2x2 block with REAL distinct eigenvalues of the product:
    # block product eigs of ([[1,b],[c,1]] @ [[1,b],[c,1]])-ish stay real
    T[0][0:2, 0:2] = np.array([[1.0, 2.0], [0.4, 1.0]])
    T[1][0:2, 0:2] = np.array([[1.0, 0.3], [0.0, 1.0]])
    Z = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0]
                  for _ in range(p)])
    # left orientation: Z[(l+1)%p]^T A[l] Z[l] = T[l]
    A = np.stack([Z[(l + 1) % p] @ T[l] @ Z[l].T for l in range(p)])
    W = T[1][0:2, 0:2] @ T[0][0:2, 0:2]
    wblk = np.linalg.eigvals(W)
    assert np.abs(wblk.imag).max() == 0.0 and abs(wblk[0] - wblk[1]) > 0.1
    lam_all = np.zeros(n, complex)
    lam_all[0:2] = wblk
    for j in range(2, n):
        lam_all[j] = T[0][j, j] * T[1][j, j]
    P = PeriodicSchur(Ts=jnp.asarray(T), Zs=jnp.asarray(Z),
                      values=jnp.asarray(lam_all), orientation="L",
                      schurindex=0)
    select = [True, False] + [False] * (n - 2)   # widened structurally
    Vs = eigvecs(P, select)
    assert Vs[0].shape == (n, 2)
    # the in-block order of the two real eigenvalues is solver-defined:
    # match each returned column to whichever eigenvalue it satisfies,
    # and require BOTH eigenvalues to be covered
    matched = []
    for col in range(2):
        ok_lams = []
        for lam in wblk:
            try:
                ev_check(A, [np.asarray(v)[:, col:col + 1] for v in Vs],
                         [lam], left=True, tol=1e-8)
                ok_lams.append(lam)
            except AssertionError:
                pass
        assert ok_lams, f"column {col} matches neither eigenvalue"
        matched.append(ok_lams[0])
    assert abs(matched[0] - matched[1]) > 0.1, "both columns matched one"
