"""Real periodic QR core: Francis double-shift on a Hessenberg/triangular cycle.

Behavioral contract from the reference's real `pschur!`
(src/PeriodicSchurDecompositions.jl:322-1096, MB03WD semantics): quasi-
triangularize ``H[0]`` (Hessenberg) against upper-triangular ``H[1..p-1]``
without forming the product ``ℍ = H0 H1 ... Hp-1``:

* tridiagonal-band entries of ℍ are evaluated from banded recurrences over
  the cycle — here VECTORIZED over the row index (an improvement over the
  reference's scalar k-scan; same math),
* deflation uses the LAPACK-style Ahues-Tisseur test with the reference's
  tightened threshold ``eps^(1 + at_pwr16/16)``
  (src/PeriodicSchurDecompositions.jl:291-295),
* negligible-product subdiagonals trigger the RQ-type repair chain that
  restores triangularity of the trailing factors (:589-665),
* shifts are Francis double shifts (dlahqr-style) with the two exceptional
  variants at its == 10 and its % 10 == 0 (:681-699),
* the bulge is a 3-element reflector chased down with per-factor
  re-triangularization by one 3-reflector plus one 2-reflector (:806-886),
* 1x1/2x2 deflation standardizes trailing 2x2s with dlanv2 and handles the
  negligible-diagonal chain-shortening cases (:895-1054).

Everything runs in ONE ``lax.while_loop``; work arrays are padded by one
ghost row/column so 3-row slabs near the bottom edge stay statically shaped.

Deviations (documented): the ``tol == 0`` 1-norm fallbacks are replaced by
the smlnum floor; the eigenvalue-swap check after a replacement rotation
compares against the freshly computed pair (the reference compares against
``λ[1], λ[2]`` — absolute indices — which appears to be a typo);
``allow_early_qr`` is intentionally not carried over (see config.AlgoConfig).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..config import AlgoConfig, default_config
from ..types import ConvergenceFailure, PeriodicSchur
from ..utils.circshift import rev_alias
from .householder import refl_mat, reflector_small
from .lanv2 import lanv2
from .rotations import (colsk, getcol, getel, givens_real, lmat, rmat_adj,
                        rowsk, setcol, setel)


def _band_products(H, n):
    """Vectorized band entries of T = H[1] @ ... @ H[p-1] and ℍ = H[0] @ T.

    Returns (hdiag, hsub, hsup): ℍ[r, r], ℍ[r, r-1], ℍ[r, r+1] for all r
    (entries outside the band defined as 0).  Matches the reference's scalar
    recurrences (src/PeriodicSchurDecompositions.jl:477-528) but computed for
    every row at once.
    """
    p = H.shape[0]
    dt = H.dtype
    # P1[r] = T[r, r]; P2[r] = T[r, r+1]; P3[r] = T[r, r+2]
    P1 = jnp.ones((n,), dt)
    P2 = jnp.zeros((n,), dt)
    P3 = jnp.zeros((n,), dt)
    for l in range(1, p):
        D = jnp.diagonal(H[l])[:n]
        U = jnp.concatenate([jnp.diagonal(H[l], 1)[:n - 1], jnp.zeros((1,), dt)])
        V = jnp.concatenate([jnp.diagonal(H[l], 2)[:n - 2], jnp.zeros((2,), dt)])
        D1 = jnp.concatenate([D[1:], jnp.zeros((1,), dt)])    # D[r+1]
        U1 = jnp.concatenate([U[1:], jnp.zeros((1,), dt)])    # U[r+1]
        D2 = jnp.concatenate([D[2:], jnp.zeros((2,), dt)])    # D[r+2]
        P3 = P1 * V + P2 * U1 + P3 * D2
        P2 = P1 * U + P2 * D1
        P1 = P1 * D
    d0 = jnp.diagonal(H[0])[:n]
    u0 = jnp.concatenate([jnp.diagonal(H[0], 1)[:n - 1], jnp.zeros((1,), dt)])
    s0 = jnp.concatenate([jnp.zeros((1,), dt), jnp.diagonal(H[0], -1)[:n - 1]])
    # ℍ[r, r-1] = H0[r, r-1] * T[r-1, r-1]
    P1m = jnp.concatenate([jnp.ones((1,), dt), P1[:-1]])
    P2m = jnp.concatenate([jnp.zeros((1,), dt), P2[:-1]])
    P3m = jnp.concatenate([jnp.zeros((1,), dt), P3[:-1]])
    hsub = s0 * P1m
    # ℍ[r, r] = H0[r, r-1] * T[r-1, r] + H0[r, r] * T[r, r]
    hdiag = s0 * P2m + d0 * P1
    # ℍ[r, r+1] = H0[r, r-1]*T[r-1, r+1] + H0[r, r]*T[r, r+1] + H0[r, r+1]*T[r+1, r+1]
    P11 = jnp.concatenate([P1[1:], jnp.zeros((1,), dt)])
    hsup = s0 * P3m + d0 * P2 + u0 * P11
    return hdiag, hsub, hsup


@partial(jax.jit, static_argnames=("want_z", "want_t", "maxitfac", "cfg",
                                   "with_info"))
def pqr_real_core(
    H: jax.Array,
    Z: Optional[jax.Array] = None,
    want_z: bool = True,
    want_t: bool = True,
    maxitfac: int = 30,
    cfg: AlgoConfig = default_config,
    with_info: bool = False,
):
    """Run the real periodic QR iteration.

    Args:
      H: (p, n, n) real stack; H[0] upper Hessenberg, H[1:] upper triangular.
      Z: optional (p, n, n) initial orthogonal stack (accumulated into).
      want_z: accumulate Schur vectors.
      want_t: when False, restrict all row/column updates to the active
        deflation window (the reference's ``ifirstm:ilastm`` device,
        src/PeriodicSchurDecompositions.jl wantT=false path): eigenvalues
        stay exact, the returned T stack is valid only on its diagonal
        blocks.
      maxitfac: total iteration budget factor (maxit = maxitfac * n).

    Returns:
      (T, Z, wr, wi, ok): T quasi-triangularized stack (T[0] is the real
      Schur factor), eigenvalues wr + i*wi, success flag.  With
      ``with_info=True`` a trailing dict with iteration counters is appended
      (the reference prints these tallies at verbosity > 0,
      src/PeriodicSchurDecompositions.jl:457-459).
    """
    p, n, _ = H.shape
    dt = H.dtype
    fi = jnp.finfo(dt)
    ulp = float(fi.eps)
    unfl = float(fi.tiny)
    smlnum = unfl * (n / ulp)
    ulpx = cfg.ulp_x(ulp)
    dat1 = 0.75
    dat2 = -0.4375
    maxit = maxitfac * n

    if n == 1:
        lam = jnp.prod(H[:, 0, 0])
        Zo = (jnp.broadcast_to(jnp.eye(1, dt), (p, 1, 1)) if Z is None else Z) \
            if want_z else None
        out1 = (H, Zo, lam[None], jnp.zeros((1,), dt), jnp.asarray(True))
        return out1 + ({"niter": jnp.int32(0), "maxit": jnp.int32(maxit)},) \
            if with_info else out1

    # hnorms: deflation thresholds for triangular-factor diagonals
    # (reference :379-388: s * opnorm(Hs[j], 1) with s = ulp * n)
    hnorms = ulp * n * jnp.max(jnp.sum(jnp.abs(H), axis=1), axis=1)  # (p,)

    # pad with one ghost row/col so 3-slabs at the bottom stay in bounds
    Hp_ = jnp.zeros((p, n + 1, n + 1), dt).at[:, :n, :n].set(H)
    if want_z:
        Zinit = jnp.broadcast_to(jnp.eye(n, dtype=dt), (p, n, n)) if Z is None else Z
        Zp_ = jnp.zeros((p, n + 1, n + 1), dt).at[:, :n, :n].set(Zinit)
    else:
        Zp_ = jnp.zeros((p, 1, 1), dt)

    iv = jnp.arange(n, dtype=jnp.int32)
    zero = jnp.zeros((), dt)

    def zup(Z, l, k, M, active=None):
        if not want_z:
            return Z
        return Z.at[l].set(colsk(Z[l], k, M, active=active))

    # =================================================================
    def body(st):
        (H, Z, wr, wi, i, l, its, itleft, jiter) = st

        hdiag, hsub, hsup = _band_products(H, n)

        # ---- deflation scan over k in [l+1, i], bottom-most hit ------
        hh11 = jnp.concatenate([jnp.zeros((1,), dt), hdiag[:-1]])  # hdiag[k-1]
        hh12 = jnp.concatenate([jnp.zeros((1,), dt), hsup[:-1]])   # ℍ[k-1, k]
        hh21 = hsub                                                # ℍ[k, k-1]
        hh22 = hdiag
        tst1 = jnp.abs(hh11) + jnp.abs(hh22)
        ab = jnp.maximum(jnp.abs(hh21), jnp.abs(hh12))
        ba = jnp.minimum(jnp.abs(hh21), jnp.abs(hh12))
        aa = jnp.maximum(jnp.abs(hh22), jnp.abs(hh11 - hh22))
        bb = jnp.minimum(jnp.abs(hh22), jnp.abs(hh11 - hh22))
        stmp = aa + ab
        stmps = jnp.where(stmp == 0, 1.0, stmp)
        if cfg.slicot_convg:
            found_k = jnp.abs(hh21) <= jnp.maximum(ulp * tst1, smlnum)
        else:
            at_ok = ba * (ab / stmps) <= jnp.maximum(
                smlnum, ulpx * (bb * (aa / stmps)))
            found_k = (jnp.abs(hh21) <= smlnum) | \
                      ((jnp.abs(hh21) <= ulp * tst1) & at_ok)
            # stagnation relaxation to the plain dlahqr criterion after
            # 16 fruitless iterations in a window — the tightened AT
            # product test can reject a ulp-negligible coupling forever
            # on extreme-graded product bands while the Francis column
            # degenerates to e1
            found_k |= (its >= jnp.int32(16)) & \
                (jnp.abs(hh21) <= jnp.maximum(ulp * tst1, smlnum))
        in_range = (iv >= l + 1) & (iv <= i)
        found_k &= in_range
        anyf = jnp.any(found_k)
        klast = jnp.max(jnp.where(found_k, iv, -1))
        lnew = jnp.where(i > l, jnp.where(anyf, klast, l), i)

        # wantT=false: restrict every H update to the active window
        # [lnew, i] (the reference's ifirstm:ilastm device); eigenvalues are
        # unaffected because nothing outside the window is ever read again.
        tlo = None if want_t else lnew
        thi = None if want_t else i + 1

        # ---- subdiagonal repair when ℍ[l, l-1] negligible but H0's is not
        def repair(HZ):
            H, Z = HZ
            # chain over k from i down to lnew
            def rep_step(t, HZ):
                H, Z = HZ
                k = i - t
                act = k >= lnew
                for f in range(0, p - 1):
                    # annihilate H[f][k, k-1] from the right
                    x0 = getel(H[f], k, k)
                    x1 = getel(H[f], k, k - 1)
                    w, tau, beta = reflector_small(jnp.stack([x0, x1]))
                    # column-pair (k-1, k) reflector vector is (w[1], 1)
                    wv = jnp.stack([w[1], jnp.ones((), dt)])
                    M2 = jnp.eye(2, dtype=dt) - tau * jnp.outer(wv, wv)
                    Hf = setel(H[f], k, k - 1, zero, active=act)
                    Hf = setel(Hf, k, k, beta, active=act)
                    Hf = colsk(Hf, k - 1, M2, lo=tlo, hi=k, active=act)
                    H = H.at[f].set(Hf)
                    H = H.at[f + 1].set(
                        rowsk(H[f + 1], k - 1, M2, lo=k - 1, hi=thi,
                              active=act))
                    Z = zup(Z, f + 1, k - 1, M2, active=act)
                # annihilate H[p-1][k+1, k] (if k < i)
                act2 = act & (k < i)
                x0 = getel(H[p - 1], k + 1, k + 1)
                x1 = getel(H[p - 1], k + 1, k)
                w, tau, beta = reflector_small(jnp.stack([x0, x1]))
                wv = jnp.stack([w[1], jnp.ones((), dt)])
                M2 = jnp.eye(2, dtype=dt) - tau * jnp.outer(wv, wv)
                Hl = setel(H[p - 1], k + 1, k, zero, active=act2)
                Hl = setel(Hl, k + 1, k + 1, beta, active=act2)
                Hl = colsk(Hl, k, M2, lo=tlo, hi=k + 1, active=act2)
                H = H.at[p - 1].set(Hl)
                H = H.at[0].set(rowsk(H[0], k, M2, lo=k, hi=thi, active=act2))
                Z = zup(Z, 0, k, M2, active=act2)
                return H, Z

            H, Z = lax.fori_loop(0, n, rep_step, (H, Z))
            if cfg.extra_rq:
                # final RQ stage absent from MB03WD (reference :637-652):
                # annihilate H[p-1][lnew, lnew-1] properly instead of
                # forcing it to zero
                x0 = getel(H[p - 1], lnew, lnew)
                x1 = getel(H[p - 1], lnew, lnew - 1)
                w, tau, beta = reflector_small(jnp.stack([x0, x1]))
                wv = jnp.stack([w[1], jnp.ones((), dt)])
                M2 = jnp.eye(2, dtype=dt) - tau * jnp.outer(wv, wv)
                Hl = setel(H[p - 1], lnew, lnew - 1, zero)
                Hl = setel(Hl, lnew, lnew, beta)
                Hl = colsk(Hl, lnew - 1, M2, lo=tlo, hi=lnew)
                H = H.at[p - 1].set(Hl)
                H = H.at[0].set(rowsk(H[0], lnew - 1, M2, lo=lnew - 1,
                                      hi=thi))
                Z = zup(Z, 0, lnew - 1, M2)
            else:
                # MB03WD forces the leftover to zero, even when wrong
                H = H.at[p - 1].set(setel(H[p - 1], lnew, lnew - 1, zero))
            return H, Z

        t1r = jnp.abs(getel(H[0], lnew - 1, lnew - 1)) + jnp.abs(
            getel(H[0], lnew, lnew))
        need_repair = (lnew > 0) & (p > 1) & (
            jnp.abs(getel(H[0], lnew, lnew - 1)) >
            jnp.maximum(ulp * t1r, smlnum))
        H, Z = lax.cond(need_repair, repair, lambda x: x, (H, Z))
        H = H.at[0].set(setel(H[0], lnew, lnew - 1, zero, active=lnew > 0))

        splitting = lnew >= i - 1

        # =============================================================
        # bulge-chase branch
        def do_chase(HZ):
            H, Z = HZ
            # ---- shift (reference :681-763) --------------------------
            exc1 = its == 10
            exc2 = (its % 10 == 0) & (~exc1)
            exc = exc1 | exc2
            sE = jnp.where(
                exc1,
                jnp.abs(hsub[jnp.clip(lnew + 1, 0, n - 1)]) +
                jnp.abs(hsub[jnp.clip(lnew + 2, 0, n - 1)]),
                jnp.abs(hsub[i]) + jnp.abs(hsub[jnp.clip(i - 1, 0, n - 1)]))
        # exceptional-shift quantities
            h44E = dat1 * sE + jnp.where(exc1, hdiag[lnew], hdiag[i])
            h33E = h44E
            h43h34E = dat2 * sE * sE
            # normal Francis quantities
            h44 = hdiag[i]
            h33 = hdiag[jnp.clip(i - 1, 0, n - 1)]
            h43 = hsub[i]
            h34 = hsup[jnp.clip(i - 1, 0, n - 1)]
            h43h34 = h43 * h34
            ssh = jnp.abs(h33) + jnp.abs(h34) + jnp.abs(h43) + jnp.abs(h44)
            sshs = jnp.where(ssh == 0, 1.0, ssh)
            h33n, h44n, h34n, h43n = h33 / sshs, h44 / sshs, h34 / sshs, h43 / sshs
            trc = (h33n + h44n) * 0.5
            disc = (h33n - trc) * (h44n - trc) - h34n * h43n
            rtdisc = jnp.sqrt(jnp.abs(disc))
            rt1r_c = trc * ssh
            rt1i_c = rtdisc * ssh
            r1 = trc + rtdisc
            r2 = trc - rtdisc
            pick = jnp.where(jnp.abs(r1 - h44n) <= jnp.abs(r2 - h44n), r1, r2)
            rt1r = jnp.where(ssh == 0, 0.0,
                             jnp.where(disc >= 0, rt1r_c, pick * ssh))
            rt2r = rt1r
            rt1i = jnp.where(ssh == 0, 0.0, jnp.where(disc >= 0, rt1i_c, 0.0))
            rt2i = -rt1i

            # ---- first column of the shifted product at m = lnew ------
            m = lnew
            h11 = hdiag[m]
            h12 = hsup[m]
            h21 = hsub[jnp.clip(m + 1, 0, n - 1)]
            h22 = hdiag[jnp.clip(m + 1, 0, n - 1)]
            hsub_m2 = hsub[jnp.clip(m + 2, 0, n - 1)]
            # exceptional / slicot variant
            h44s = h44E - h11
            h33s = h33E - h11
            h21s_ = jnp.where(h21 == 0, 1.0, h21)
            v1E = (h33s * h44s - h43h34E) / h21s_ + h12
            v2E = h22 - h11 - h33s - h44s
            v3E = hsub_m2
            # lapack variant
            sv = jnp.abs(h11 - rt2r) + jnp.abs(rt2i) + jnp.abs(h21)
            svs = jnp.where(sv == 0, 1.0, sv)
            h21s = h21 / svs
            v1L = h21s * h12 + (h11 - rt1r) * ((h11 - rt2r) / svs) - \
                rt1i * (rt2i / svs)
            v2L = h21s * (h11 + h22 - rt1r - rt2r)
            v3L = h21s * hsub_m2
            use_exc = exc | cfg.slicot_shifts
            v1 = jnp.where(use_exc, v1E, v1L)
            v2 = jnp.where(use_exc, v2E, v2L)
            v3 = jnp.where(use_exc, v3E, v3L)
            snorm = jnp.abs(v1) + jnp.abs(v2) + jnp.abs(v3)
            snorms = jnp.where(snorm == 0, 1.0, snorm)
            v0 = jnp.stack([v1, v2, v3]) / snorms

            if cfg.allow_early_qr:
                # ---- _allow_early_QR (reference :768-801): scan m from
                # i-2 down for a row where starting the double shift
                # leaves ℍ[m, m-1] negligible; the sweep then starts at
                # the LARGEST such m (the reference breaks at the first
                # hit from the top).  Vectorized over all rows at once —
                # the scan is scale-invariant, so the unnormalized first
                # columns are tested directly.
                h11v = hdiag
                h12v = hsup
                h21v = jnp.concatenate([hsub[1:], jnp.zeros((1,), dt)])
                h22v = jnp.concatenate([hdiag[1:], jnp.zeros((1,), dt)])
                h32v = jnp.concatenate([hsub[2:], jnp.zeros((2,), dt)])
                hdm1 = jnp.concatenate([jnp.zeros((1,), dt), hdiag[:-1]])
                h21gs = jnp.where(h21v == 0, 1.0, h21v)
                h44sv = h44E - h11v
                h33sv = h33E - h11v
                v1Ev = (h33sv * h44sv - h43h34E) / h21gs + h12v
                v2Ev = h22v - h11v - h33sv - h44sv
                v3Ev = h32v
                svv = jnp.abs(h11v - rt2r) + jnp.abs(rt2i) + jnp.abs(h21v)
                svvs = jnp.where(svv == 0, 1.0, svv)
                h21sv = h21v / svvs
                v1Lv = h21sv * h12v + (h11v - rt1r) * \
                    ((h11v - rt2r) / svvs) - rt1i * (rt2i / svvs)
                v2Lv = h21sv * (h11v + h22v - rt1r - rt2r)
                v3Lv = h21sv * h32v
                v1v = jnp.where(use_exc, v1Ev, v1Lv)
                v2v = jnp.where(use_exc, v2Ev, v2Lv)
                v3v = jnp.where(use_exc, v3Ev, v3Lv)
                tst1v = jnp.abs(v1v) * (jnp.abs(hdm1) + jnp.abs(h11v) +
                                        jnp.abs(h22v))
                okv = (jnp.abs(hsub) * (jnp.abs(v2v) + jnp.abs(v3v)) <=
                       ulp * tst1v) & (iv >= lnew + 1) & (iv <= i - 2)
                mlast = jnp.maximum(
                    jnp.max(jnp.where(okv, iv, jnp.int32(-1))), lnew)
                mc = jnp.clip(mlast, 0, n - 1)
                sne = jnp.abs(v1v[mc]) + jnp.abs(v2v[mc]) + jnp.abs(v3v[mc])
                snes = jnp.where(sne == 0, 1.0, sne)
                v0e = jnp.stack([v1v[mc], v2v[mc], v3v[mc]]) / snes
                early = mlast > lnew
                v0 = jnp.where(early, v0e, v0)
                m = mlast

            # ---- double-shift QR chase (reference :806-886) -----------
            def chase_step(k, carry):
                H, Z, v = carry
                act = (k >= m) & (k <= i - 1)
                nr3 = (i - k + 1) >= 3  # reflector order is 3 else 2
                hi_r = jnp.minimum(k + 3, i) + 1  # rows 0..min(k+nr,i)
                col = getcol(H[0], k, k - 1, 3)
                vk = jnp.where(k > m, col, v)
                vk = jnp.where(nr3, vk, vk * jnp.array([1.0, 1.0, 0.0], dt))
                w, tau, beta = reflector_small(vk)
                M3 = refl_mat(w, tau)
                newc = jnp.stack([jnp.asarray(beta, dt), zero,
                                  jnp.where(k < i - 1, zero, col[2])])
                H0 = setcol(H[0], k, k - 1, newc, active=act & (k > m))
                if cfg.allow_early_qr:
                    # early-start first step: the reflector's first row
                    # also acts on column m-1 — LAPACK dlahqr's
                    # underflow-safe form H(M,M-1) *= (1-τ); the rows
                    # m+1, m+2 fill-in is negligible by the scan's test
                    # and dropped, exactly as in dlahqr (reference :832)
                    H0 = setel(H0, k, k - 1,
                               getel(H0, k, k - 1) * (1.0 - tau),
                               active=act & (k == m) & early)
                H0 = rowsk(H0, k, M3, lo=k, hi=thi, active=act)
                H = H.at[0].set(H0)
                H = H.at[p - 1 if p > 1 else 0].set(
                    colsk(H[p - 1 if p > 1 else 0], k, M3, lo=tlo, hi=hi_r,
                          active=act))
                Z = zup(Z, 0, k, M3, active=act)
                for f in range(p - 1, 0, -1):
                    colv = getcol(H[f], k, k, 3)
                    colv = jnp.where(nr3, colv, colv * jnp.array(
                        [1.0, 1.0, 0.0], dt))
                    w2, tau2, beta2 = reflector_small(colv)
                    M3b = refl_mat(w2, tau2)
                    newc = jnp.stack([jnp.asarray(beta2, dt), zero,
                                      jnp.where(nr3, zero, colv[2])])
                    Hf = setcol(H[f], k, k, newc, active=act)
                    Hf = rowsk(Hf, k, M3b, lo=k + 1, hi=thi, active=act)
                    H = H.at[f].set(Hf)
                    H = H.at[f - 1].set(colsk(H[f - 1], k, M3b, lo=tlo,
                                              hi=hi_r, active=act))
                    Z = zup(Z, f, k, M3b, active=act)
                    # second (2-element) re-triangularization when nr == 3
                    act2 = act & nr3
                    xc = getcol(H[f], k + 1, k + 1, 2)
                    wb, taub, betab = reflector_small(xc)
                    M2 = refl_mat(wb, taub)
                    Hf = setcol(H[f], k + 1, k + 1,
                                jnp.stack([jnp.asarray(betab, dt), zero]),
                                active=act2)
                    Hf = rowsk(Hf, k + 1, M2, lo=k + 2, hi=thi, active=act2)
                    H = H.at[f].set(Hf)
                    H = H.at[f - 1].set(colsk(H[f - 1], k + 1, M2, lo=tlo,
                                              hi=hi_r, active=act2))
                    Z = zup(Z, f, k + 1, M2, active=act2)
                return H, Z, v

            H, Z, _ = lax.fori_loop(0, n, chase_step, (H, Z, v0))
            return H, Z

        H, Z = lax.cond(splitting, lambda x: x, do_chase, (H, Z))

        # =============================================================
        # deflation branch
        def do_deflate(HZwrwi):
            H, Z, wr, wi = HZwrwi
            one_only = lnew == i

            # ---- 1x1 ------------------------------------------------
            def defl1(HZwrwi):
                H, Z, wr, wi = HZwrwi
                wr = wr.at[i].set(hdiag[i])
                wi = wi.at[i].set(0.0)
                return H, Z, wr, wi

            # ---- 2x2 ------------------------------------------------
            def defl2(HZwrwi):
                H, Z, wr, wi = HZwrwi
                # recompute the 2x2 product block from current matrices
                hp22 = jnp.ones((), dt)
                hp12 = jnp.zeros((), dt)
                hp11 = jnp.ones((), dt)
                for f in range(1, p):
                    d1 = getel(H[f], i - 1, i - 1)
                    d2 = getel(H[f], i, i)
                    u = getel(H[f], i - 1, i)
                    hp12 = hp11 * u + hp12 * d2
                    hp11 = hp11 * d1
                    hp22 = hp22 * d2
                a11 = getel(H[0], i - 1, i - 1)
                a12 = getel(H[0], i - 1, i)
                a21 = getel(H[0], i, i - 1)
                a22 = getel(H[0], i, i)
                bh11 = a11 * hp11
                bh12 = a11 * hp12 + a12 * hp22
                bh21 = a21 * hp11
                bh22 = a21 * hp12 + a22 * hp22
                (_, _, cc_, _, cs0, sn0,
                 w1r, w1i, w2r, w2i) = lanv2(bh11, bh12, bh21, bh22)
                lam_real = cc_ == 0
                wr = wr.at[i - 1].set(w1r)
                wi = wi.at[i - 1].set(w1i)
                wr = wr.at[i].set(w2r)
                wi = wi.at[i].set(w2i)

                # negligible-diagonal detection in the triangular factors
                lv = jnp.arange(p, dtype=jnp.int32)
                dm1 = jnp.abs(lax.dynamic_slice(
                    H, (jnp.int32(0), i - 1, i - 1), (p, 1, 1))[:, 0, 0])
                dm0 = jnp.abs(lax.dynamic_slice(
                    H, (jnp.int32(0), i, i), (p, 1, 1))[:, 0, 0])
                has_min = (dm1 <= hnorms) & (lv >= 1)
                has_max = (dm0 <= hnorms) & (lv >= 1)
                jmin = jnp.min(jnp.where(has_min, lv, p + 1))
                jmax = jnp.max(jnp.where(has_max, lv, -1))
                jmin = jnp.where(jmin > p, -1, jmin)
                both = (jmin >= 0) & (jmax >= 0)
                # shorter-path choice (reference :951-958, 1-based arith)
                prefer_min = (jmin + 1 - 1) <= (p - (jmax + 1) + 1)
                jmax = jnp.where(both & prefer_min, -1, jmax)
                jmin = jnp.where(both & (~prefer_min), -1, jmin)

                # --- branch A: jmin-chain (reference :959-977) --------
                def chainA(HZ):
                    H, Z = HZ
                    for f in range(0, p - 1):
                        act = f <= jmin - 2
                        x0 = getel(H[f], i, i)
                        x1 = getel(H[f], i, i - 1)
                        w, tau, beta = reflector_small(jnp.stack([x0, x1]))
                        wv = jnp.stack([w[1], jnp.ones((), dt)])
                        M2 = jnp.eye(2, dtype=dt) - tau * jnp.outer(wv, wv)
                        Hf = setel(H[f], i, i - 1, zero, active=act)
                        Hf = setel(Hf, i, i, beta, active=act)
                        Hf = colsk(Hf, i - 1, M2, lo=tlo, hi=i, active=act)
                        H = H.at[f].set(Hf)
                        H = H.at[f + 1].set(
                            rowsk(H[f + 1], i - 1, M2, lo=i - 1, hi=thi,
                                  active=act))
                        Z = zup(Z, f + 1, i - 1, M2, active=act)
                    return H, Z

                # --- branch B: rotation + retriangularization ---------
                def chainB(HZ):
                    H, Z = HZ
                    a1 = jnp.hypot(w1r, w1i)
                    a2 = jnp.hypot(w2r, w2i)
                    amx = jnp.maximum(a1, a2)
                    amn = jnp.minimum(a1, a2)
                    prod0 = ((w1r == 0) & (w1i == 0)) | ((w2r == 0) & (w2i == 0))
                    tinyrat = amn < ulp * amx
                    replace0 = ((jmax >= 1) & lam_real) | prod0 | \
                        ((~prod0) & lam_real & tinyrat)

                    def iter20(t, carry):
                        H, Z, replaceG, done = carry
                        act = ~done
                        cg, sg, _ = givens_real(getel(H[0], i - 1, i - 1),
                                                getel(H[0], i, i - 1))
                        c = jnp.where(replaceG, cg, cs0)
                        s = jnp.where(replaceG, sg, sn0)
                        H0 = rowsk(H[0], i - 1, lmat(c, s), lo=i - 1, hi=thi, active=act)
                        H = H.at[0].set(H0)
                        H = H.at[p - 1 if p > 1 else 0].set(
                            colsk(H[p - 1 if p > 1 else 0], i - 1,
                                  rmat_adj(c, s), lo=tlo, hi=i + 1,
                                  active=act))
                        Z = zup(Z, 0, i - 1, rmat_adj(c, s), active=act)
                        for f in range(p - 1, 0, -1):
                            actf = act & (f >= jmax + 1)
                            x = jnp.stack([getel(H[f], i - 1, i - 1),
                                           getel(H[f], i, i - 1)])
                            w_, tau_, beta_ = reflector_small(x)
                            M2 = refl_mat(w_, tau_)
                            Hf = setel(H[f], i - 1, i - 1, beta_, active=actf)
                            Hf = setel(Hf, i, i - 1, zero, active=actf)
                            Hf = rowsk(Hf, i - 1, M2, lo=i, hi=thi, active=actf)
                            H = H.at[f].set(Hf)
                            H = H.at[f - 1].set(
                                colsk(H[f - 1], i - 1, M2, lo=tlo, hi=i + 1,
                                      active=actf))
                            Z = zup(Z, f, i - 1, M2, active=actf)
                        sub = jnp.abs(getel(H[0], i, i - 1))
                        conv = (~replaceG) | (sub < jnp.maximum(
                            smlnum, ulp * amx))
                        done = done | conv
                        return H, Z, jnp.asarray(True), done

                    H, Z, _, _ = lax.fori_loop(
                        0, 20, iter20, (H, Z, replace0, jnp.asarray(False)))
                    # forced zeros (reference :1031-1038)
                    H = H.at[0].set(setel(H[0], i, i - 1, zero,
                                          active=(jmax >= 0) | (bh21 == 0)))
                    def zmax(H):
                        Hf = dget_f(H, jmax)
                        Hf = setel(Hf, i, i - 1, zero)
                        return dset_f(H, jmax, Hf)
                    H = lax.cond(jmax >= 1, zmax, lambda x: x, H)
                    return H, Z

                def dget_f(A, f):
                    return lax.dynamic_slice(
                        A, (jnp.asarray(f, jnp.int32), jnp.int32(0),
                            jnp.int32(0)), (1,) + A.shape[1:])[0]

                def dset_f(A, f, M):
                    return lax.dynamic_update_slice(
                        A, M[None], (jnp.asarray(f, jnp.int32), jnp.int32(0),
                                     jnp.int32(0)))

                H, Z = lax.cond(jmin >= 1, chainA, chainB, (H, Z))

                # eigenvalue-order check after replacement rotations
                # (sensible variant of reference :1039-1051)
                l1 = getel(H[0], i - 1, i - 1)
                l2 = getel(H[0], i, i)
                for f in range(1, p):
                    l1 = l1 * getel(H[f], i - 1, i - 1)
                    l2 = l2 * getel(H[f], i, i)
                swap = lam_real & (jnp.abs(l1 - w1r) > jnp.abs(l1 - w2r))
                wr1, wr2 = wr[i - 1], wr[i]
                wr = wr.at[i - 1].set(jnp.where(swap, wr2, wr1))
                wr = wr.at[i].set(jnp.where(swap, wr1, wr2))
                return H, Z, wr, wi

            return lax.cond(one_only, defl1, defl2, (H, Z, wr, wi))

        H, Z, wr, wi = lax.cond(
            splitting, do_deflate, lambda x: x, (H, Z, wr, wi))

        itleft = jnp.where(splitting, itleft - its, itleft)
        i = jnp.where(splitting, lnew - 1, i)
        l = jnp.where(splitting, jnp.int32(0), lnew)
        its = jnp.where(splitting, jnp.int32(1), its + 1)
        return (H, Z, wr, wi, i, l, its, itleft, jiter + 1)

    def cond(st):
        (H, Z, wr, wi, i, l, its, itleft, jiter) = st
        return (i >= 0) & (jiter < maxit)

    def body_guarded(st):
        # no-op once converged: keeps semantics exact under vmap (a batched
        # while_loop keeps stepping until every lane's cond is false)
        return lax.cond(st[4] >= 0, body, lambda s: s, st)

    wr0 = jnp.zeros((n,), dt)
    wi0 = jnp.zeros((n,), dt)
    st = (Hp_, Zp_, wr0, wi0, jnp.int32(n - 1), jnp.int32(0), jnp.int32(1),
          jnp.int32(maxit), jnp.int32(0))
    H, Z, wr, wi, i, l, its, itleft, jiter = lax.while_loop(cond, body_guarded, st)
    ok = i < 0

    H = H[:, :n, :n]
    Z = Z[:, :n, :n] if want_z else None
    if want_t:
        # scrub subdiagonals of real eigenvalues (reference :1066-1073)
        sub = jnp.diagonal(H[0], -1) * jnp.where(wi[:-1] == 0, 0.0, 1.0)
        H0 = H[0] - jnp.diag(jnp.diagonal(H[0], -1), -1) + jnp.diag(sub, -1)
        H = H.at[0].set(H0)
        # triangular factors: exact zero lower parts
        if p > 1:
            H = H.at[1:].set(jnp.triu(H[1:]))
    if with_info:
        return H, Z, wr, wi, ok, {"niter": jiter,
                                  "maxit": jnp.int32(maxit)}
    return H, Z, wr, wi, ok


def pschur_real_pipeline(A, orient, want_t=True, want_z=True, maxitfac=30,
                         cfg: AlgoConfig = default_config):
    """Full real PSD: reduction + iteration + packaging (reference :120-152).

    Inputs, cores and results stay on the input's device.
    """
    from .hessenberg import phessenberg_core
    p = A.shape[0]
    if orient == "L":
        A = A[::-1]
    from ..config import verbosity
    H, Q = phessenberg_core(A, want_q=want_z)
    verb = verbosity("main")
    if verb >= 1:
        T, Z, wr, wi, ok, info = pqr_real_core(
            H, Z=Q, want_z=want_z, want_t=want_t, maxitfac=maxitfac, cfg=cfg,
            with_info=True)
        print(f"[pschur real] p={p} n={A.shape[-1]}: "
              f"{int(info['niter'])} iterations "
              f"(budget {int(info['maxit'])}), converged={bool(ok)}")
    else:
        T, Z, wr, wi, ok = pqr_real_core(H, Z=Q, want_z=want_z, want_t=want_t,
                                         maxitfac=maxitfac, cfg=cfg)
    if not bool(ok):
        raise ConvergenceFailure(-1)
    P = PeriodicSchur(Ts=T, Zs=Z, values=lax.complex(wr, wi),
                      orientation="R", schurindex=0)
    if orient == "L":
        P = rev_alias(P)
        # rev_alias reverses eigenvalue-free data only; values unchanged
    return P
