"""Complex and signed (generalized) scenarios through the public API.

Complex128 periodic Schur and periodic QZ cycles (``pschur`` with complex
input and/or a signature ``S``, and ``gpschur``), after the reference's
test/generalized.jl and test/rgeneralized.jl families: random cycles in
both orientations, mixed signatures, graded and exponentially split
factors, exact zero diagonals planted in direct factors (zero eigenvalues)
and in inverted factors (infinite eigenvalues), and the eigenvalue-only
path.  Oracles: the contract (check_psd) and eigenvalues against
``eigvals`` of the explicit signed product.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import periodicschurdecompositions_jax as psd

N = 6
S4 = [(True, False, True, False), (True, True, False, False),
      (True, False, False, True)]


def match_error(a, b):
    rest = list(np.asarray(b, complex))
    worst = 0.0
    for x in sorted(np.asarray(a, complex), key=lambda z: -abs(z)):
        d = np.abs(np.asarray(rest) - x)
        j = int(np.argmin(d))
        worst = max(worst, float(d[j]))
        rest.pop(j)
    return worst


def signed_product(A, S, lr):
    if lr == "L":
        A, S = A[::-1], tuple(reversed(S))
    M = np.eye(A.shape[1], dtype=A.dtype)
    for a, s in zip(A, S):
        M = M @ (a if s else np.linalg.inv(a))
    return M


def draw(rng, p, n, cplx):
    A = rng.standard_normal((p, n, n))
    if cplx:
        A = A + 1j * rng.standard_normal((p, n, n))
    return A


def check(A, S=None, lr="R", eig_tol=1e-8, **kw):
    P = psd.pschur(jnp.asarray(A), lr, S=S, **kw)
    if kw.get("want_z", True) and kw.get("want_t", True):
        ok, rep = psd.check_psd(P, A)
        assert ok, rep
    Sx = S if S is not None else (True,) * A.shape[0]
    w = np.linalg.eigvals(signed_product(A, Sx, lr))
    vals = np.asarray(P.values)
    err = match_error(vals, w) / np.abs(w).max()
    assert err < eig_tol, err
    return P


@pytest.mark.parametrize("lr", ["R", "L"])
@pytest.mark.parametrize("p", [2, 6, 12])
def test_complex_random_cycle(rng, p, lr):
    check(draw(rng, p, N, True), lr=lr)


@pytest.mark.parametrize("cplx", [True, False])
@pytest.mark.parametrize("S", S4)
def test_mixed_signature(rng, S, cplx):
    check(draw(rng, len(S), N, cplx), S)


@pytest.mark.parametrize("cplx", [True, False])
def test_mixed_signature_left(rng, cplx):
    check(draw(rng, 4, N, cplx), S4[2], lr="L")


@pytest.mark.parametrize("cplx", [True, False])
def test_graded_signed_cycle(rng, cplx):
    """Direct factors graded by rows and columns over six decades."""
    S = S4[0]
    A = draw(rng, 4, N, cplx)
    g = 10.0 ** np.linspace(-3, 3, N)
    for l in range(4):
        if S[l]:
            A[l] = g[:, None] * A[l] / g[None, :]
        else:
            A[l] += 3 * np.eye(N)
    check(A, S)


@pytest.mark.parametrize("cplx", [True, False])
def test_exp_split_signed_cycle(rng, cplx):
    """Diagonals fac^k in every factor, inverted or not: eigenvalues spread
    over decades in both directions."""
    S = S4[0]
    p = len(S)
    A = []
    for l in range(p):
        d = 0.3 ** (1 + 2 * rng.random(N))
        T = np.triu(draw(rng, 1, N, cplx)[0], 1) * 0.1 * d.max()
        np.fill_diagonal(T, d)
        q = np.linalg.qr(draw(rng, 1, N, cplx)[0])[0]
        A.append(q @ T @ q.conj().T)
    check(np.stack(A), S)


def easy_cycle(rng, S, cplx):
    """Hessenberg factor first, the others upper triangular: the reduction
    leaves it alone, so planted zero diagonals reach the iteration exactly
    (the reference's planted-hole construction)."""
    p = len(S)
    H = draw(rng, p, N, cplx)
    H[0] = np.triu(H[0], -1)
    for l in range(1, p):
        H[l] = np.triu(H[l]) + 2 * np.eye(N)
    return H


@pytest.mark.parametrize("hole", [0, 3, N - 1])
@pytest.mark.parametrize("cplx", [True, False])
def test_zero_diagonal_direct_factor(rng, cplx, hole):
    S = S4[0]
    H = easy_cycle(rng, S, cplx)
    H[2][hole, hole] = 0.0
    P = psd.pschur(jnp.asarray(H), S=S)
    ok, rep = psd.check_psd(P, H, tol=500.0)
    assert ok, rep
    vals = np.asarray(P.values)
    assert np.sum(np.abs(vals) == 0.0) == 1, vals


@pytest.mark.parametrize("hole", [0, 2, N - 1])
@pytest.mark.parametrize("cplx", [True, False])
def test_zero_diagonal_inverted_factor(rng, cplx, hole):
    S = S4[0]
    H = easy_cycle(rng, S, cplx)
    H[1][hole, hole] = 0.0
    P = psd.pschur(jnp.asarray(H), S=S)
    ok, rep = psd.check_psd(P, H, tol=500.0)
    assert ok, rep
    # the pencil eigenvalue is flagged infinite (beta == 0) or, when the
    # reduction's unitary phases leave the planted zero at roundoff level,
    # astronomically large
    vals = np.abs(np.asarray(P.values))
    big = ~np.isfinite(vals) | (vals > 1e12 * np.median(vals))
    assert np.sum(big) == 1, (np.asarray(P.beta), vals)


@pytest.mark.parametrize("cplx", [True, False])
def test_gpschur_pairs(rng, cplx):
    """gpschur(As, Bs): eigenvalues of B_{p-1}^-1 A_{p-1} ... B_0^-1 A_0."""
    ph = 3
    As = list(draw(rng, ph, N, cplx))
    Bs = list(draw(rng, ph, N, cplx) + 3 * np.eye(N))
    G = psd.gpschur([jnp.asarray(a) for a in As], [jnp.asarray(b) for b in Bs])
    M = np.eye(N, dtype=As[0].dtype)
    for j in range(ph):
        M = np.linalg.solve(Bs[j], As[j]) @ M
    w = np.linalg.eigvals(M)
    assert match_error(np.asarray(G.values), w) / np.abs(w).max() < 1e-8


@pytest.mark.parametrize("cplx", [True, False])
def test_signed_eigenvalues_only(rng, cplx):
    P = check(draw(rng, 4, N, cplx), S4[0], want_t=False, want_z=False)
    assert P.Zs is None or np.asarray(P.Zs).shape[-1] <= 1
