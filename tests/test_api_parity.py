"""API-surface parity tests (reference test/runtests.jl + generalized.jl)."""
import numpy as np
import jax.numpy as jnp
import pytest

import periodicschurdecompositions_jax as psd

EPS = np.finfo(np.float64).eps


def test_want_z_false_gpschur(rng):
    A = rng.standard_normal((3, 6, 6)) + 1j * rng.standard_normal((3, 6, 6))
    P = psd.pschur(jnp.asarray(A), "R", S=(True, False, True), want_z=False)
    P2 = psd.pschur(jnp.asarray(A), "R", S=(True, False, True))
    v1 = sorted(np.asarray(P.values), key=lambda z: (abs(z), np.angle(z)))
    v2 = sorted(np.asarray(P2.values), key=lambda z: (abs(z), np.angle(z)))
    assert np.allclose(v1, v2, rtol=1e-8)
    assert P.Zs is None or P.Zs.shape[-1] <= 1


def test_infinite_eigenvalue_via_gpschur(rng):
    # singular B -> infinite eigenvalue of B^{-1} A chains
    As = [rng.standard_normal((4, 4)) + 3 * np.eye(4) for _ in range(2)]
    Bs = [rng.standard_normal((4, 4)) + 3 * np.eye(4) for _ in range(2)]
    Bs[0][2, :] = 0.0  # rank-deficient
    # make it exactly singular upper-triangularizable: zero a diagonal after QR
    G = psd.gpschur([jnp.asarray(a) for a in As], [jnp.asarray(b) for b in Bs])
    beta = np.asarray(G.beta)
    vals = np.asarray(G.values)
    # after the reduction the planted zero becomes ~eps-level, so the pencil
    # eigenvalue is either flagged infinite (beta == 0) or astronomically
    # large (the reference guarantees exact detection only for zeros planted
    # directly on pre-reduced triangular diagonals; see the planted-hole
    # tests in test_pqz_complex/test_pqz_real for that contract)
    assert (beta == 0).sum() >= 1 or np.abs(vals).max() > 1e12


def test_complex_p1(rng):
    A = rng.standard_normal((1, 7, 7)) + 1j * rng.standard_normal((1, 7, 7))
    P = psd.pschur(jnp.asarray(A))
    ok, rep = psd.check_psd(P, A)
    assert ok, rep
    w = np.linalg.eigvals(A[0])
    v = np.asarray(P.values)
    ws = sorted(w, key=lambda z: (abs(z), np.angle(z)))
    vs = sorted(v, key=lambda z: (abs(z), np.angle(z)))
    assert max(abs(a - b) for a, b in zip(ws, vs)) < 1e-10


def test_check_psd_negative(rng):
    A = rng.standard_normal((2, 5, 5))
    P = psd.pschur(jnp.asarray(A))
    ok, _ = psd.check_psd(P, A)
    assert ok
    # against the wrong input it must fail
    ok2, _ = psd.check_psd(P, A + 1e-3)
    assert not ok2


def test_list_input_and_properties(rng):
    As = [rng.standard_normal((5, 5)) for _ in range(3)]
    P = psd.pschur([jnp.asarray(a) for a in As])
    assert P.period == 3 and P.n == 5
    assert len(P.T) == 2 and len(P.Z) == 3
    T1 = np.asarray(P.T1)
    assert np.abs(np.tril(T1, -2)).max() == 0.0


def test_expsplit_gpschur(rng):
    # exponentially-split spectrum through the generalized real core
    fac = 0.1
    p = 4
    A1 = np.array([[9, 4, 1, 4], [6, 8, 2, 4], [0, 7, 4, 4],
                   [0, 0, 8, 4]], float)
    Aj = np.diag([fac, fac ** 2, 1, 1])
    A = np.stack([A1] + [Aj] * (p - 1))
    P = psd.pschur(jnp.asarray(A), "R", S=(True,) * p)
    ok, rep = psd.check_psd(P, A, tol=500)
    assert ok, rep
    prod = np.linalg.multi_dot(list(A))
    w = sorted(np.linalg.eigvals(prod), key=abs)
    v = sorted(np.asarray(P.values), key=abs)
    for a, b in zip(w, v):
        err = min(abs(a - b), abs(a - np.conj(b)))
        assert err < 1e-4 * max(abs(a), 1e-10), (a, b)


def test_maxitfac_failure(rng):
    from periodicschurdecompositions_jax.types import ConvergenceFailure
    A = rng.standard_normal((2, 12, 12))
    with pytest.raises(ConvergenceFailure):
        psd.pschur(jnp.asarray(A), maxitfac=1)


def test_want_t_false_real(rng):
    """wantT=false fast path: eigenvalues match the full run exactly in
    distribution (reference test/runtests.jl:102-132); the returned T stack
    is only window-diagonal-valid, so it is not checked."""
    A = rng.standard_normal((3, 10, 10))
    P_full = psd.pschur(jnp.asarray(A), "R")
    P_fast = psd.pschur(jnp.asarray(A), "R", want_t=False, want_z=False)
    v1 = np.sort_complex(np.asarray(P_full.values))
    v2 = np.sort_complex(np.asarray(P_fast.values))
    scale = max(np.abs(v1).max(), 1.0)
    assert np.abs(v1 - v2).max() < 1e-9 * scale


def test_want_t_false_with_z(rng):
    """want_z=True, want_t=False: Z is still the exact Schur basis (checked
    against the full run's Z up to column signs on a distinct-eigenvalue
    cycle is too strict; instead check orthogonality + eigenvalues)."""
    A = rng.standard_normal((2, 8, 8))
    P = psd.pschur(jnp.asarray(A), "R", want_t=False)
    Z = np.asarray(P.Zs)
    n = Z.shape[-1]
    for l in range(Z.shape[0]):
        assert np.abs(Z[l] @ Z[l].T - np.eye(n)).max() < 1e-12
    P_full = psd.pschur(jnp.asarray(A), "R")
    v1 = np.sort_complex(np.asarray(P_full.values))
    v2 = np.sort_complex(np.asarray(P.values))
    assert np.abs(v1 - v2).max() < 1e-9 * max(np.abs(v1).max(), 1.0)


def test_want_t_false_complex(rng):
    """wantT=false windowing in the complex QZ core (reference
    src/generalized.jl:202-227,756-775): eigenvalues equal the full run."""
    p, n = 3, 10
    A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
    P_full = psd.pschur(jnp.asarray(A), "R")
    P_fast = psd.pschur(jnp.asarray(A), "R", want_t=False, want_z=False)
    v1 = np.sort_complex(np.asarray(P_full.values))
    v2 = np.sort_complex(np.asarray(P_fast.values))
    scale = max(np.abs(v1).max(), 1.0)
    assert np.abs(v1 - v2).max() < 1e-9 * scale


def test_want_t_false_complex_generalized(rng):
    p, n = 3, 8
    A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
    S = (True, False, True)
    P_full = psd.pschur(jnp.asarray(A), "R", S=S)
    P_fast = psd.pschur(jnp.asarray(A), "R", S=S, want_t=False, want_z=False)
    v1 = np.sort_complex(np.asarray(P_full.values))
    v2 = np.sort_complex(np.asarray(P_fast.values))
    scale = max(np.abs(v1).max(), 1.0)
    assert np.abs(v1 - v2).max() < 1e-9 * scale


def test_want_t_false_real_generalized(rng):
    """wantT=false windowing in the real QZ core (reference
    src/rgeneralized.jl:895-1054 ifirstm:ilastm device)."""
    p, n = 3, 8
    A = rng.standard_normal((p, n, n))
    S = (True, False, True)
    P_full = psd.pschur(jnp.asarray(A), "R", S=S)
    P_fast = psd.pschur(jnp.asarray(A), "R", S=S, want_t=False, want_z=False)
    v1 = np.sort_complex(np.asarray(P_full.values))
    v2 = np.sort_complex(np.asarray(P_fast.values))
    scale = max(np.abs(v1).max(), 1.0)
    assert np.abs(v1 - v2).max() < 1e-9 * scale


def test_want_t_false_split_backend(rng):
    """Same contract through the split-complex core."""
    p, n = 2, 8
    A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
    P_full = psd.pschur(jnp.asarray(A), "R", backend="split")
    P_fast = psd.pschur(jnp.asarray(A), "R", backend="split",
                        want_t=False, want_z=False)
    v1 = np.sort_complex(np.asarray(P_full.values))
    v2 = np.sort_complex(np.asarray(P_fast.values))
    scale = max(np.abs(v1).max(), 1.0)
    assert np.abs(v1 - v2).max() < 1e-9 * scale
