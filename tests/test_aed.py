"""Tests for periodic aggressive early deflation (ops/aed.py).

AED is a beyond-reference convergence accelerator; correctness oracles are
the usual ones (orthogonal transforms, reconstruction, eigenvalues vs the
explicit product) plus equivalence of the accelerated chunked driver with
the plain core.
"""
import numpy as np
import jax.numpy as jnp

import pytest

from periodicschurdecompositions_jax.config import AlgoConfig
from periodicschurdecompositions_jax.ops.aed import aed_analyze

EPS = np.finfo(np.float64).eps


def _window(rng, p, w):
    H = np.stack([np.triu(rng.standard_normal((w, w)), -1 if l == 0 else 0)
                  for l in range(p)])
    return H


def test_aed_analyze_tiny_coupling_deflates_all(rng):
    """beta ~ 0: the whole window is converged; AED must adopt its Schur
    form wholesale (d == w) with orthogonal transforms and exact
    eigenvalues."""
    p, w = 3, 10
    Hwin = _window(rng, p, w)
    beta = 1e-25
    tol = EPS * w * np.abs(Hwin[0]).sum(axis=0).max()
    res = aed_analyze(Hwin, beta, tol)
    assert res is not None
    d, Wf, Zt, vals, sph = res
    assert d == w
    # transforms orthogonal
    for l in range(p):
        assert np.abs(Zt[l] @ Zt[l].T - np.eye(w)).max() < 100 * EPS * w
    # reconstruction: Zt[l]^T Hwin[l] Zt[l+1] = Wf[l]
    for l in range(p):
        R = Zt[l].T @ Hwin[l] @ Zt[(l + 1) % p]
        assert np.abs(R - Wf[l]).max() < 1e3 * EPS * np.abs(Hwin[l]).max()
    # eigenvalues match the window product
    wprod = np.linalg.multi_dot(list(Hwin)) if p > 1 else Hwin[0]
    w_ref = np.linalg.eigvals(wprod)
    vs = sorted(vals, key=lambda z: (abs(z), z.imag))
    ws = sorted(w_ref, key=lambda z: (abs(z), z.imag))
    scale = max(np.abs(w_ref).max(), 1.0)
    assert max(abs(a - b) for a, b in zip(vs, ws)) < 1e4 * EPS * scale


def test_aed_analyze_generic_window_mostly_none(rng):
    """O(1) coupling on a random (unconverged) window: spikes are O(beta),
    nothing deflates."""
    p, w = 2, 12
    Hwin = _window(rng, p, w)
    tol = EPS * w * np.abs(Hwin[0]).sum(axis=0).max()
    res = aed_analyze(Hwin, 1.7, tol)
    assert res is None


def test_aed_partial_deflation_structure(rng):
    """Plant a decoupled converged trailing block inside the window plus a
    live leading part: AED must deflate the trailing eigenvalues, keep the
    leading ones, and return a leading part in periodic Hessenberg form
    with the spike compressed to alpha e1."""
    p, w, conv = 3, 12, 5
    Hwin = _window(rng, p, w)
    u0 = w - conv
    # decouple the trailing block and make it already-quasi-triangular by
    # construction (a tiny converged subproblem's Schur form)
    sub = _window(rng, p, conv)
    from periodicschurdecompositions_jax.ops.pqr_real import pqr_real_core
    T, Z, wr, wi, ok = pqr_real_core(jnp.asarray(sub), want_z=False)
    assert bool(ok)
    Hwin[:, u0:, u0:] = np.asarray(T)
    Hwin[0][u0, u0 - 1] = 0.0
    beta = 0.9
    tol = EPS * w * np.abs(Hwin[0]).sum(axis=0).max()
    res = aed_analyze(Hwin, beta, tol)
    assert res is not None
    d, Wf, Zt, vals, sph = res
    assert d >= conv
    u = w - d
    # leading window back in periodic Hessenberg form
    assert np.abs(np.tril(Wf[0][:u, :u], -2)).max() == 0.0
    for l in range(1, p):
        assert np.abs(np.tril(Wf[l][:u, :u], -1)).max() == 0.0
    # spike compressed: alpha at slot 0, zeros elsewhere
    assert np.all(sph[1:] == 0.0)
    # deflated eigenvalues are (a subset of) the planted block's
    w_ref = np.linalg.eigvals(np.linalg.multi_dot(list(np.asarray(T))))
    for v in vals[u:]:
        assert min(abs(v - z) for z in w_ref) < 1e5 * EPS * max(
            1.0, np.abs(w_ref).max())
    # transforms orthogonal + reconstruction
    for l in range(p):
        assert np.abs(Zt[l] @ Zt[l].T - np.eye(w)).max() < 100 * EPS * w
        R = Zt[l].T @ Hwin[l] @ Zt[(l + 1) % p]
        # spike-zeroing perturbs H0 only at negligible entries; compare
        # away from the first column of the deflated rows
        assert np.abs(R - Wf[l]).max() < 1e3 * EPS * max(
            1.0, np.abs(Hwin[l]).max()) + 2 * tol


# ---------------------------------------------------------------------------
# complex / generalized variant


def _cwindow(rng, p, w):
    H = np.stack([np.triu(rng.standard_normal((w, w)) +
                          1j * rng.standard_normal((w, w)),
                          -1 if l == 0 else 0) for l in range(p)])
    return H


def test_aed_analyze_cx_tiny_coupling(rng):
    """Complex/generalized window with ~zero coupling: everything
    deflates; reconstruction respects the signature sides."""
    from periodicschurdecompositions_jax.ops.aed import aed_analyze_cx
    p, w = 3, 8
    S = (True, False, True)
    Hwin = _cwindow(rng, p, w)
    tol = EPS * w * np.abs(Hwin[0]).sum(axis=0).max()
    res = aed_analyze_cx(Hwin, S, 1e-25 + 0j, tol)
    assert res is not None
    d, Wf, Zt, al, be, sc, sph = res
    assert d == w
    for l in range(p):
        assert np.abs(Zt[l] @ Zt[l].conj().T - np.eye(w)).max() < 1e3 * EPS
        ln = (l + 1) % p
        if S[l]:
            R = Zt[l].conj().T @ Hwin[l] @ Zt[ln]
        else:
            R = Zt[ln].conj().T @ Hwin[l] @ Zt[l]
        assert np.abs(R - Wf[l]).max() < 1e4 * EPS * np.abs(Hwin[l]).max()
    # eigenvalues vs the explicit signed product
    M = np.eye(w, dtype=complex)
    for l in range(p):
        M = M @ (Hwin[l] if S[l] else np.linalg.inv(Hwin[l]))
    w_ref = np.linalg.eigvals(M)
    vals = al / be * np.exp2(sc.astype(np.float64))
    rest = list(w_ref)
    for v in vals:
        j = min(range(len(rest)), key=lambda q: abs(v - rest[q]))
        assert abs(v - rest[j]) < 1e4 * EPS * max(1.0, np.abs(w_ref).max())
        rest.pop(j)


def test_chunked_aed_rg_end_to_end(rng):
    """Real generalized chunked driver with AED: residual + eigenvalue
    agreement with the plain core; AED fires."""
    from periodicschurdecompositions_jax.ops.hessenberg import (
        phessenberg_signed_core)
    from periodicschurdecompositions_jax.ops.pqz_real import (
        pqz_real_gen_core, pqz_real_gen_core_chunked)
    import periodicschurdecompositions_jax.ops.aed as aed_mod
    p, n = 3, 36
    S = (True, False, True)
    A = rng.standard_normal((p, n, n))
    H64, Q64 = phessenberg_signed_core(jnp.asarray(A), S, want_q=True)
    cfg = AlgoConfig(aed=True, aed_window=10, aed_interval=8)
    defl0 = aed_mod.stats["deflated"]
    T, Z, ar, ai, be, sc, ok = pqz_real_gen_core_chunked(
        H64, S, Z=Q64, want_z=True, chunk_iters=8, cfg=cfg)
    assert aed_mod.stats["deflated"] > defl0, "rg AED never fired"
    assert bool(ok)
    T = np.asarray(T)
    Z = np.asarray(Z)
    scale = np.abs(A).max()
    for l in range(p):
        ln = (l + 1) % p
        Ax = (Z[l] @ T[l] @ Z[ln].T) if S[l] else (Z[ln] @ T[l] @ Z[l].T)
        assert np.abs(Ax - A[l]).max() < 1e-11 * n * scale, l
    # eigenvalues vs the plain (non-AED) core
    _, _, ar0, ai0, be0, sc0, ok0 = pqz_real_gen_core(
        H64, S, Z=None, want_z=False)
    assert bool(ok0)
    v0 = np.sort_complex((np.asarray(ar0) + 1j * np.asarray(ai0)) /
                         np.asarray(be0) *
                         np.exp2(np.asarray(sc0).astype(np.float64)))
    v1 = np.sort_complex((np.asarray(ar) + 1j * np.asarray(ai)) /
                         np.asarray(be) *
                         np.exp2(np.asarray(sc).astype(np.float64)))
    assert np.abs(v1 - v0).max() < 1e-8 * max(1.0, np.abs(v0).max())


def test_aed_analyze_randomized_invariants():
    """Randomized stress: whatever AED decides, the invariants must hold —
    orthogonal transforms, reconstruction up to the spike tolerance, and
    deflated eigenvalues drawn from the window product's spectrum."""
    for seed in range(5):
        rng = np.random.default_rng(1000 + seed)
        p, w = 3, 10
        Hwin = _window(rng, p, w)
        # plant a converged trailing block half the time
        if seed % 2 == 0:
            conv = 4
            from periodicschurdecompositions_jax.ops.pqr_real import (
                pqr_real_core)
            sub = _window(rng, p, conv)
            T, _, _, _, ok = pqr_real_core(jnp.asarray(sub), want_z=False)
            assert bool(ok)
            Hwin[:, w - conv:, w - conv:] = np.asarray(T)
            Hwin[0][w - conv, w - conv - 1] = 0.0
        beta = float(rng.standard_normal())
        tol = EPS * w * np.abs(Hwin[0]).sum(axis=0).max()
        res = aed_analyze(Hwin, beta, tol)
        if res is None:
            continue
        d, Wf, Zt, vals, sph = res
        u = w - d
        w_ref = np.linalg.eigvals(np.linalg.multi_dot(list(Hwin)))
        scale = max(np.abs(w_ref).max(), 1.0)
        for l in range(p):
            assert np.abs(Zt[l] @ Zt[l].T - np.eye(w)).max() < 1e3 * EPS
            R = Zt[l].T @ Hwin[l] @ Zt[(l + 1) % p]
            assert np.abs(R - Wf[l]).max() < 1e3 * EPS * max(
                1.0, np.abs(Hwin[l]).max()) + 2 * tol
        for v in vals[u:]:
            assert min(abs(v - z) for z in w_ref) < 1e6 * EPS * scale
        assert np.all(sph[1:] == 0.0)
        # leading part back in periodic Hessenberg form
        if u > 0:
            assert np.abs(np.tril(Wf[0][:u, :u], -2)).max() == 0.0
            for l in range(1, p):
                assert np.abs(np.tril(Wf[l][:u, :u], -1)).max() == 0.0


@pytest.mark.parametrize("S,s", [((True, False), 7), ((True, True), 0),
                                 ((True, False, False), 4)])
def test_aed_apply_rg_matches_host(rng, S, s):
    """The device application of real-generalized AED transforms agrees
    with the f64 host transform (signature-aware sides; Z plain; no spike
    write at the window head s == 0)."""
    from periodicschurdecompositions_jax.ops.aed import aed_apply_rg
    p, n, w = len(S), 16, 6
    H = _window(rng, p, n)
    Z = np.broadcast_to(np.eye(n), (p, n, n)).copy()
    Zt = np.stack([np.linalg.qr(rng.standard_normal((w, w)))[0]
                   for _ in range(p)])
    Wf = np.stack([rng.standard_normal((w, w)) for _ in range(p)])
    sp = rng.standard_normal(w)
    Hg, Zg = aed_apply_rg(jnp.asarray(H), jnp.asarray(Z), jnp.asarray(Zt),
                          jnp.asarray(Wf), jnp.asarray(sp), jnp.int32(s), S,
                          want_z=True)
    Hg, Zg = np.asarray(Hg), np.asarray(Zg)
    for l in range(p):
        ln = (l + 1) % p
        ref = H[l].copy()
        Vl = Zt[l] if S[l] else Zt[ln]
        Vr = Zt[ln] if S[l] else Zt[l]
        ref[s:s + w, :] = Vl.T @ ref[s:s + w, :]
        ref[:, s:s + w] = ref[:, s:s + w] @ Vr
        ref[s:s + w, s:s + w] = Wf[l]
        if l == 0 and s >= 1:
            ref[s:s + w, s - 1] = sp
        assert np.abs(Hg[l] - ref).max() < 1e-13 * max(
            1.0, np.abs(ref).max()), l
        zref = Z[l].copy()
        zref[:, s:s + w] = zref[:, s:s + w] @ Zt[l]
        assert np.abs(Zg[l] - zref).max() < 1e-13
