"""Periodic Krylov-Schur tests (mirrors reference test/krylov.jl strategy)."""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.models.krylov import partial_pschur


def mkmats(rng, p, n, xpnd=1.25, cplx=False):
    """Cycle with known well-spread spectrum from triangular seeds
    (reference mkmats1, test/krylov.jl:35-56)."""
    lams = xpnd ** np.arange(n) * (1.0 + (0.3j if cplx else 0.0))
    dt = complex if cplx else float
    # build A[l] = Q[(l+1)%p] T_l Q[l]^H with random unitary Q[l], so the
    # LEFT-orientation product A[p-1]...A[0] = Q[0] (T_{p-1}..T_0) Q[0]^H
    # has the planted spectrum (reference mkmats1, test/krylov.jl:35-56,
    # applies the same cyclic similarity)
    mu = np.abs(lams) ** (1.0 / p)

    def rand_q():
        g = rng.standard_normal((n, n))
        if cplx:
            g = g + 1j * rng.standard_normal((n, n))
        q, _ = np.linalg.qr(g)
        return q

    Qs = [rand_q() for _ in range(p)]
    A = []
    for l in range(p):
        T = np.triu(rng.standard_normal((n, n)) * 0.1, 1).astype(dt)
        d = mu.astype(dt)
        if l == 0 and cplx:
            d = d * (lams / np.abs(lams))  # phases into the first factor
        if l == 0 and not cplx:
            d = d * np.sign(lams.real)
        T += np.diag(d)
        A.append(Qs[(l + 1) % p] @ T @ Qs[l].conj().T)
    return np.stack(A).astype(dt)


def check_partial(A, ps, otol=100):
    """Reference `check` (test/krylov.jl:6-26): per-column residuals of the
    Schur-factor relation below max(|lam_i|, ||B|| eps), orthonormal bases."""
    A = np.asarray(A)
    p = A.shape[0]
    V = np.asarray(ps.Vs)
    T = np.asarray(ps.Ts)
    k = V.shape[2]
    assert k > 0
    eps = np.finfo(A.real.dtype).eps
    b = np.linalg.norm(T[p - 1])
    vals = np.asarray(ps.values)
    R = A[p - 1] @ V[p - 1] - V[0] @ T[p - 1]
    cnrms = np.linalg.norm(R, axis=0)
    thresh = np.maximum(np.abs(vals[:k]), b * eps)
    assert np.all(cnrms < thresh), (cnrms, thresh)
    # the interior couplings hold to the same per-column level
    for l in range(p - 1):
        R = A[l] @ V[l] - V[(l + 1) % p] @ T[l]
        assert np.linalg.norm(R, axis=0).max() < max(
            np.abs(vals).max(), 1.0), (l, np.abs(R).max())
    for l in range(p):
        G = V[l].conj().T @ V[l]
        assert np.abs(G - np.eye(k)).max() < otol * k * eps


_KEYS = {
    "LM": lambda z: -abs(z),
    "LR": lambda z: -z.real,
    "SR": lambda z: z.real,
    "LI": lambda z: -z.imag,
    "SI": lambda z: z.imag,
}


def _check_found_among_best(A, ps, which, nev):
    """Found values must be among the top 2*nev of the true spectrum
    (reference pkstest1, test/krylov.jl:58-97)."""
    A = np.asarray(A)
    n = A.shape[1]
    M = np.eye(n, dtype=A.dtype)
    for l in range(A.shape[0]):
        M = A[l] @ M
    w = np.linalg.eigvals(M)
    w_sorted = sorted(w, key=_KEYS[which])
    best = w_sorted[:2 * nev]
    for v in np.asarray(ps.values):
        d = min(min(abs(v - b), abs(v - np.conj(b))) for b in best)
        assert d < 1e-5 * max(abs(v), 1), (which, v, best)


@pytest.mark.parametrize("which", ["LM", "LR", "SR"])
def test_krylov_real(rng, which):
    p, n, nev = 3, 30, 4
    A = mkmats(rng, p, n)
    ps, hist = partial_pschur(A, nev, which, seed=7)
    assert hist.nconverged >= nev // 2, hist
    check_partial(A, ps)
    _check_found_among_best(A, ps, which, nev)


@pytest.mark.parametrize("which", ["LM", "LI", "SI"])
def test_krylov_complex(rng, which):
    p, n, nev = 2, 24, 3
    A = mkmats(rng, p, n, cplx=True)
    ps, hist = partial_pschur(A, nev, which, seed=3)
    assert hist.nconverged >= 1
    check_partial(A, ps)
    if hist.nconverged >= nev:
        _check_found_among_best(A, ps, which, nev)


def test_krylov_matrix_free(rng):
    p, n, nev = 2, 40, 3
    A = mkmats(rng, p, n)
    ops = [lambda x, a=A[l]: a @ x for l in range(p)]
    ps, hist = partial_pschur(ops, nev, "LM", n=n, dtype=np.float64, seed=5)
    assert hist.nconverged >= 1
    check_partial(A, ps)


def test_krylov_large_matrix_free(rng):
    """BASELINE config 5 scale: p=12 operators, N=10000, matrix-free."""
    p, n, nev = 12, 10000, 5
    # cheap structured operators: diagonal + shift coupling (tridiagonal-ish)
    diags = [0.5 + rng.random(n) for _ in range(p)]
    offs = [0.1 * rng.standard_normal(n - 1) for _ in range(p)]
    # make a few dominant modes so LM converges quickly
    for d in diags:
        d[:6] += np.linspace(3.0, 1.5, 6)

    def mk(l):
        def op(x, d=diags[l], o=offs[l]):
            y = d * x
            y[:-1] += o * x[1:]
            return y
        return op

    ops = [mk(l) for l in range(p)]
    ps, hist = partial_pschur(ops, nev, "LM", n=n, dtype=np.float64,
                              mindim=12, maxdim=26, seed=11)
    assert hist.nconverged >= 2, hist
    V = np.asarray(ps.Vs)
    T = np.asarray(ps.Ts)
    k = V.shape[2]
    for l in range(p):
        Av = np.stack([ops[l](V[l][:, j]) for j in range(k)], axis=1)
        R = Av - V[(l + 1) % p] @ T[l]
        assert np.abs(R).max() < 1e-5, (l, np.abs(R).max())


def test_krylov_custom_vrand(rng):
    """User-injected restart filler (reference vrand!, src/krylov.jl:454):
    a deterministic custom filler must be used and give reproducible runs."""
    p, n, nev = 2, 30, 3
    A = mkmats(rng, p, n)
    calls = []

    def filler(shape):
        calls.append(shape)
        rloc = np.random.default_rng(99 + len(calls))
        return rloc.standard_normal(shape)

    ps1, h1 = partial_pschur(A, nev, "LM", vrand=filler)
    assert calls, "custom vrand was never invoked"
    calls2 = []

    def filler2(shape):
        calls2.append(shape)
        rloc = np.random.default_rng(99 + len(calls2))
        return rloc.standard_normal(shape)

    ps2, h2 = partial_pschur(A, nev, "LM", vrand=filler2)
    assert np.allclose(np.asarray(ps1.values), np.asarray(ps2.values))
    check_partial(A, ps1)


def test_direct_residuals_match_trial_probe(rng):
    """The cyclic-Sylvester residual fast path must agree with the
    reference's trial-reorder probe: exactly for 1x1 candidates, within
    sqrt(2) (+ rounding headroom) for conjugate pairs (projection 2-norm
    vs basis-dependent max-|entry|)."""
    from periodicschurdecompositions_jax.models.krylov import (
        _residual_trial, _residuals, _small_pschur)

    for dtype in (np.float64, np.complex128):
        p, kk = 3, 9
        B = [np.triu(rng.standard_normal((kk + 1, kk + 1))).astype(dtype)
             for _ in range(p - 1)]
        Bp = np.triu(rng.standard_normal((kk + 1, kk + 1)), -1).astype(dtype)
        if np.issubdtype(dtype, np.complexfloating):
            B = [b + 1j * np.triu(rng.standard_normal(b.shape))
                 for b in B]
            Bp = Bp + 1j * np.triu(rng.standard_normal(Bp.shape), -1)
        Bl = B + [Bp]
        PS = _small_pschur(Bl, 0, kk, np.dtype(dtype))
        foot = rng.standard_normal(kk).astype(dtype)
        lams = np.asarray(PS.values)
        isreal_t = not np.issubdtype(dtype, np.complexfloating)
        rs = _residuals(PS, foot, list(range(kk)), lams, isreal_t)
        # recompute every candidate via the trial probe and compare
        skip = False
        for j in range(kk):
            if skip:
                skip = False
                continue
            lam = lams[j]
            pair = isreal_t and lam.imag != 0
            jc = None
            if pair:
                jc = j + 1 if j + 1 < kk and \
                    abs(np.conj(lams[j + 1]) - lam) <= 1e-8 * abs(lam) \
                    else j - 1
                skip = True
            rt = _residual_trial(PS, foot, j, jc, kk)
            if pair:
                assert rt / np.sqrt(2) - 1e-10 <= rs[j] <= \
                    rt * np.sqrt(2) + 1e-10, (j, rs[j], rt)
            else:
                assert abs(rs[j] - rt) <= 1e-8 * max(1.0, rt), (
                    j, rs[j], rt)


# ---------------------------------------------------------------------------
# regression tests from the adversarial review of the restart machinery


def _true_spectrum(A):
    p = A.shape[0]
    M = np.eye(A.shape[1])
    for l in range(p):
        M = A[l] @ M
    return np.linalg.eigvals(M)


def test_restarts_with_locking_random_sweep():
    """Generic real cycles that need several restarts + locking: the
    restore/truncation path used to double-transform locked coupling rows
    and split 2x2 blocks at the preference cut (26/30 failures)."""
    bad = 0
    for trial in range(8):
        rng = np.random.default_rng(5000 + trial)
        p, n = 3, 26
        A = rng.standard_normal((p, n, n))
        PS, hist = partial_pschur(A, nev=4, which="LM", mindim=6, maxdim=12,
                                  seed=trial)
        w = _true_spectrum(A)
        got = np.asarray(PS.values)[:hist.nconverged]
        for g in got:
            err = min(abs(g - z) for z in w)
            if err > 1e-5 * max(1.0, abs(g)):
                bad += 1
                break
    assert bad == 0, f"{bad}/8 random locking runs returned wrong values"


@pytest.mark.parametrize("which", ["LI", "SI"])
def test_krylov_real_li_si(which):
    """Real dtype LI/SI: conjugate partners must stay adjacent in the
    preference order (the raw imag-signed key sorted them to opposite
    ends and produced half-pair locks)."""
    rng = np.random.default_rng(77)
    p, n = 2, 24
    A = rng.standard_normal((p, n, n))
    PS, hist = partial_pschur(A, nev=3, which=which, seed=3)
    assert hist.nconverged >= 2
    w = _true_spectrum(A)
    got = np.asarray(PS.values)[:hist.nconverged]
    for g in got:
        assert min(abs(g - z) for z in w) < 1e-6 * max(1.0, abs(g)), g


def test_maxdim_validation():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 8, 8))
    with pytest.raises(ValueError):
        partial_pschur(A, 2, "LM", mindim=10, maxdim=16)


def test_zero_factor_terminates():
    """A zero factor must terminate (budget) instead of retrying forever."""
    n = 8
    A = np.stack([np.zeros((n, n)), np.eye(n)])
    PS, hist = partial_pschur(A, nev=2, which="LM", restarts=3)
    assert hist.nconverged == 0 and not hist.converged


def test_rank_deficient_in_cycle_deflation():
    """Exact in-cycle deflation (rank-deficient factor): the half-sweep's
    rotation chains must keep the Krylov relations consistent."""
    rng = np.random.default_rng(11)
    n, r = 30, 8
    A0 = rng.standard_normal((n, r)) @ rng.standard_normal((r, n))
    A1 = rng.standard_normal((n, n))
    A = np.stack([A0, A1])
    PS, hist = partial_pschur(A, nev=4, which="LM", seed=2)
    assert hist.nconverged >= 1
    w = _true_spectrum(A)
    got = np.asarray(PS.values)[:hist.nconverged]
    for g in got:
        assert min(abs(g - z) for z in w) < 1e-5 * max(1.0, abs(g)), g


def test_full_space_maxdim_lucky_breakdown():
    """maxdim == n: the basis completes, the wrap closes with an EXACT
    zero foot (complete-basis lucky breakdown), and the driver returns the
    full spectrum instead of PKSFailure (the reference throws here,
    src/krylov.jl:362 -> :181; a full-space request is legitimate)."""
    rng = np.random.default_rng(5)
    for p, n, cplx in [(4, 12, False), (3, 8, True)]:
        A = rng.standard_normal((p, n, n))
        if cplx:
            A = A + 1j * rng.standard_normal((p, n, n))
        PS, hist = partial_pschur(A, nev=3, which="LM", mindim=min(10, n),
                                  maxdim=n)
        assert hist.nconverged >= 3
        w = np.sort(np.abs(_true_spectrum(A)))[::-1]
        got = np.sort(np.abs(np.asarray(PS.values)))[::-1]
        assert np.allclose(got[:3], w[:3], rtol=1e-7)
