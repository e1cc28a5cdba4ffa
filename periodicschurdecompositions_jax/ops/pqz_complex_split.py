"""Split-complex periodic QZ core (``backend="split"``).

Same algorithm as ops/pqz_complex.py (MB03BZ semantics, reference
src/generalized.jl:166-931) with every complex value carried as a
cxkern.CX (re, im) float64 pair.  It runs in true float64 on any device
and is cross-validated against the complex128 core, which is the default
route.

Also provides ``phessenberg_core_split``: the split-complex periodic
Hessenberg reduction (complex Householder columns as 4-real-matmul rank-1
updates), so the whole split pipeline is complex-free.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.safeprod import safeprod_signed_split
from . import cxkern as cxm
from .cxkern import (CX, colsk_cx, conj, getcol_cx, getel_cx, getrow_cx,
                     givens_cx, lmat_cx, mul, neg, refl_left_cx,
                     refl_right_cx, reflector_masked_cx, rmat_adj_cx,
                     rowsk_cx, setcol_cx, setel_cx, setrow_cx, where)


# ---------------------------------------------------------------------------
# split-complex periodic Hessenberg reduction (mirrors
# ops/hessenberg.phessenberg_core, reference :213-259)


def _fix_column_cx(M: CX, i, beta: CX, zero_below) -> CX:
    n = M.re.shape[0]
    i = jnp.asarray(i, jnp.int32)
    col = CX(lax.dynamic_slice(M.re, (jnp.int32(0), i), (n, 1))[:, 0],
             lax.dynamic_slice(M.im, (jnp.int32(0), i), (n, 1))[:, 0])
    rows = lax.iota(jnp.int32, n)
    piv = zero_below - 1
    nc = where(rows < piv, col,
               where(rows == piv,
                     CX(jnp.broadcast_to(beta.re, (n,)),
                        jnp.broadcast_to(beta.im, (n,))),
                     cxm.zeros((n,), M.re.dtype)))
    return CX(lax.dynamic_update_slice(M.re, nc.re[:, None], (jnp.int32(0), i)),
              lax.dynamic_update_slice(M.im, nc.im[:, None], (jnp.int32(0), i)))


@partial(jax.jit, static_argnames=("want_q",))
def phessenberg_core_split(Are: jax.Array, Aim: jax.Array,
                           want_q: bool = True):
    """Split-complex periodic Hessenberg reduction.

    Args:
      Are, Aim: (p, n, n) real/imag parts of the cycle.

    Returns (Hre, Him, Qre, Qim) with Q[j]^H A[j] Q[(j+1)%p] = H[j].
    """
    p, n, _ = Are.shape
    rdt = Are.dtype
    A = CX(Are, Aim)
    if n <= 1:
        eye = jnp.broadcast_to(jnp.eye(n, dtype=rdt), (p, n, n))
        return (Are, Aim, eye, jnp.zeros((p, n, n), rdt)) if want_q else \
            (Are, Aim, None, None)

    eye = jnp.broadcast_to(jnp.eye(n, dtype=rdt), (p, n, n)).copy()
    Q = CX(eye, jnp.zeros((p, n, n), rdt)) if want_q else None

    def fget(X: CX, j) -> CX:
        return CX(X.re[j], X.im[j])

    def fset(X: CX, j, M: CX) -> CX:
        return CX(X.re.at[j].set(M.re), X.im.at[j].set(M.im))

    def column_step(i, carry):
        A, Q = carry
        for j in range(p - 1, 0, -1):
            col = CX(
                lax.dynamic_slice(A.re[j], (jnp.int32(0),
                                            jnp.asarray(i, jnp.int32)),
                                  (n, 1))[:, 0],
                lax.dynamic_slice(A.im[j], (jnp.int32(0),
                                            jnp.asarray(i, jnp.int32)),
                                  (n, 1))[:, 0])
            w, tau, beta = reflector_masked_cx(col, i)
            Aj = refl_left_cx(fget(A, j), w, conj(tau))
            Aj = _fix_column_cx(Aj, i, beta, i + 1)
            A = fset(A, j, Aj)
            A = fset(A, j - 1, refl_right_cx(fget(A, j - 1), w, tau))
            if want_q:
                Q = fset(Q, j, refl_right_cx(fget(Q, j), w, tau))
        col = CX(
            lax.dynamic_slice(A.re[0], (jnp.int32(0),
                                        jnp.asarray(i, jnp.int32)),
                              (n, 1))[:, 0],
            lax.dynamic_slice(A.im[0], (jnp.int32(0),
                                        jnp.asarray(i, jnp.int32)),
                              (n, 1))[:, 0])
        w, tau, beta = reflector_masked_cx(col, i + 1)
        A0 = refl_left_cx(fget(A, 0), w, conj(tau))
        A0 = _fix_column_cx(A0, i, beta, i + 2)
        A = fset(A, 0, A0)
        jr = p - 1 if p > 1 else 0
        A = fset(A, jr, refl_right_cx(fget(A, jr), w, tau))
        if want_q:
            Q = fset(Q, 0, refl_right_cx(fget(Q, 0), w, tau))
        return A, Q

    A, Q = lax.fori_loop(0, n - 1, column_step, (A, Q))

    tri_re = jnp.triu(A.re[1:], 0) if p > 1 else A.re[1:]
    tri_im = jnp.triu(A.im[1:], 0) if p > 1 else A.im[1:]
    Hre = jnp.concatenate([jnp.triu(A.re[:1], -1), tri_re], axis=0)
    Him = jnp.concatenate([jnp.triu(A.im[:1], -1), tri_im], axis=0)
    if want_q:
        return Hre, Him, Q.re, Q.im
    return Hre, Him, None, None


# ---------------------------------------------------------------------------
# split-complex periodic QZ core


@partial(jax.jit, static_argnames=("S", "want_z", "maxitfac", "with_info",
                                   "want_t"))
def pqz_complex_core_split(
    Hre: jax.Array,
    Him: jax.Array,
    S: Tuple[bool, ...],
    Zre: Optional[jax.Array] = None,
    Zim: Optional[jax.Array] = None,
    want_z: bool = True,
    maxitfac: int = 30,
    seed: int = 1234,
    with_info: bool = False,
    want_t: bool = True,
):
    """Run the split-complex periodic QZ iteration (see module docstring).

    ``want_t=False`` restricts sweep updates to the active window (see
    ops/pqz_complex.pqz_complex_core; reference ifirstm:ilastm device,
    src/generalized.jl:202-227): T is then only valid on the block diagonal.

    Returns (Tre, Tim, Zre, Zim, alpha_re, alpha_im, beta, alphascale, ok).
    """
    p, n, _ = Hre.shape
    assert S[0], "signature entry S[0] must be True"
    rdt = Hre.dtype
    fi = jnp.finfo(rdt)
    ulp = float(fi.eps)
    unfl = float(fi.tiny)
    smlnum = unfl * (n / ulp)
    safmin = unfl
    maxit = maxitfac * n
    ziter0 = -1 if p >= math.log2(fi.tiny) / math.log2(ulp) else 0

    H = CX(Hre, Him)
    if want_z:
        if Zre is None:
            eye = jnp.broadcast_to(jnp.eye(n, dtype=rdt), (p, n, n))
            Z = CX(eye, jnp.zeros((p, n, n), rdt))
        else:
            Z = CX(Zre, Zim)
    else:
        Z = cxm.zeros((p, 1, 1), rdt)

    if n == 1:
        ar, ai, b, s = safeprod_signed_split(Hre[:, 0, 0], Him[:, 0, 0], S)
        zout = (Z.re, Z.im) if want_z else (None, None)
        return (Hre, Him) + zout + (ar[None], ai[None], b[None], s[None],
                                    jnp.asarray(True))

    alr0 = jnp.zeros((n,), rdt)
    ali0 = jnp.zeros((n,), rdt)
    beta0 = jnp.zeros((n,), rdt)
    scal0 = jnp.zeros((n,), jnp.int32)
    key0 = jax.random.PRNGKey(seed)

    iv = jnp.arange(n, dtype=jnp.int32)

    def zup(Z, l, k, M: CX, active=None):
        if not want_z:
            return Z
        return cxm.at_set(Z, l, colsk_cx(CX(Z.re[l], Z.im[l]), k, M,
                                         active=active))

    # ------------------------------------------------------------------
    def act_split(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        dre = lax.dynamic_slice(H.re, (jnp.int32(0), ilast, ilast),
                                (p, 1, 1))[:, 0, 0]
        dim = lax.dynamic_slice(H.im, (jnp.int32(0), ilast, ilast),
                                (p, 1, 1))[:, 0, 0]
        ar, ai, b, s = safeprod_signed_split(dre, dim, S)
        alr = alr.at[ilast].set(ar)
        ali = ali.at[ilast].set(ai)
        be = be.at[ilast].set(b)
        sc = sc.at[ilast].set(s)
        ilast = ilast - 1
        iiter = jnp.int32(0)
        ziter = jnp.where(ziter != -1, jnp.int32(0), ziter)
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    def act_czshift(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        H, Z, zflag = czshift_core(H, Z, info["jlo"], ilast)
        ziter = jnp.where(zflag, jnp.int32(1), jnp.int32(0))
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    def act_sweep(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        jlo = info["jlo"]
        ifirst = jlo
        iiter = iiter + 1
        ziter = ziter + 1

        c, s, _ = givens_cx(cxm.cx(jnp.asarray(1.0, rdt)),
                            cxm.cx(jnp.asarray(1.0, rdt)))
        for l in range(p - 1, 0, -1):
            Hl = CX(H.re[l], H.im[l])
            hf = getel_cx(Hl, ifirst, ifirst)
            hl = getel_cx(Hl, ilast, ilast)
            if S[l]:
                c, s, _ = givens_cx(cxm.mul_real(hf, c), mul(hl, conj(s)))
            else:
                c, s, _ = givens_cx(cxm.mul_real(hl, c),
                                    neg(mul(hf, conj(s))))
                s = neg(s)
        H0 = CX(H.re[0], H.im[0])
        h0f = getel_cx(H0, ifirst, ifirst)
        h0l = getel_cx(H0, ilast, ilast)
        h0sub = getel_cx(H0, ifirst + 1, ifirst)
        c, s, _ = givens_cx(cxm.sub(cxm.mul_real(h0f, c), mul(h0l, conj(s))),
                            cxm.mul_real(h0sub, c))

        key, sub = jax.random.split(key)
        fg = jax.random.normal(sub, (4,), rdt)
        ce, se, _ = givens_cx(CX(fg[0], fg[1]), CX(fg[2], fg[3]))
        exc = (iiter % 10) == 0
        c = jnp.where(exc, ce, c)
        s = where(exc, se, s)

        # want_t=False: window-limited updates (see pqz_complex_core)
        rhi = None if want_t else ilast + 1
        clo = None if want_t else jlo

        def sweep_step(k, carry):
            H, Z, c, s = carry
            act = (k >= ifirst) & (k <= ilast - 1)
            regen = act & (k > ifirst)
            H0 = CX(H.re[0], H.im[0])
            fg = getcol_cx(H0, k, k - 1, 2)
            cn, sn, r = givens_cx(CX(fg.re[0], fg.im[0]),
                                  CX(fg.re[1], fg.im[1]))
            H0 = setcol_cx(H0, k, k - 1,
                           CX(jnp.stack([r.re, jnp.zeros((), rdt)]),
                              jnp.stack([r.im, jnp.zeros((), rdt)])),
                           active=regen)
            c = jnp.where(regen, cn, c)
            s = where(regen, sn, s)
            H0 = rowsk_cx(H0, k, lmat_cx(c, s), lo=k, hi=rhi, active=act)
            H = cxm.at_set(H, 0, H0)
            Z = zup(Z, 0, k, rmat_adj_cx(c, s), active=act)
            for l in range(p - 1, 0, -1):
                Hl = CX(H.re[l], H.im[l])
                if S[l]:
                    Hl = colsk_cx(Hl, k, rmat_adj_cx(c, s), lo=clo, hi=k + 2,
                                  active=act)
                    fg = getcol_cx(Hl, k, k, 2)
                    cn, sn, r = givens_cx(CX(fg.re[0], fg.im[0]),
                                          CX(fg.re[1], fg.im[1]))
                    Hl = setcol_cx(Hl, k, k,
                                   CX(jnp.stack([r.re, jnp.zeros((), rdt)]),
                                      jnp.stack([r.im, jnp.zeros((), rdt)])),
                                   active=act)
                    Hl = rowsk_cx(Hl, k, lmat_cx(cn, sn), lo=k + 1, hi=rhi,
                                  active=act)
                else:
                    Hl = rowsk_cx(Hl, k, lmat_cx(c, s), lo=k, hi=rhi,
                                  active=act)
                    fg = getrow_cx(Hl, k + 1, k, 2)
                    cn, sn, r = givens_cx(CX(fg.re[1], fg.im[1]),
                                          CX(fg.re[0], fg.im[0]))
                    Hl = setrow_cx(Hl, k + 1, k,
                                   CX(jnp.stack([jnp.zeros((), rdt), r.re]),
                                      jnp.stack([jnp.zeros((), rdt), r.im])),
                                   active=act)
                    Hl = colsk_cx(Hl, k, lmat_cx(cn, sn), lo=clo, hi=k + 1,
                                  active=act)
                    sn = neg(sn)
                H = cxm.at_set(H, l, Hl)
                c = jnp.where(act, cn, c)
                s = where(act, sn, s)
                Z = zup(Z, l, k, rmat_adj_cx(c, s), active=act)
            H0 = colsk_cx(CX(H.re[0], H.im[0]), k, rmat_adj_cx(c, s),
                          lo=clo, hi=jnp.minimum(k + 3, n), active=act)
            H = cxm.at_set(H, 0, H0)
            return H, Z, c, s

        H, Z, c, s = lax.fori_loop(0, n - 1, sweep_step, (H, Z, c, s))
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    from .pqz_deflate_split import make_deflate_cores_split
    pos_core, neg_core, czshift_core = make_deflate_cores_split(
        p=p, n=n, S=S, rdt=rdt, want_z=want_z, ulp=ulp, smlnum=smlnum)

    def act_pos(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        H, Z = pos_core(H, Z, info["jlo"], info["ldef"], info["jdef"], ilast)
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    def act_neg(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        H, Z = neg_core(H, Z, info["jlo"], info["ldef"], info["jdef"], ilast)
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    # ------------------------------------------------------------------
    def body(full):
        st, jiter = full
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st

        def cdiag(X: CX, off=0):
            return CX(jnp.diagonal(X.re, off), jnp.diagonal(X.im, off))

        H0 = CX(H.re[0], H.im[0])
        d0 = cdiag(H0)
        sub0 = CX(jnp.concatenate([jnp.zeros((1,), rdt),
                                   jnp.diagonal(H0.re, -1)]),
                  jnp.concatenate([jnp.zeros((1,), rdt),
                                   jnp.diagonal(H0.im, -1)]))
        d0m = CX(jnp.concatenate([jnp.zeros((1,), rdt), d0.re[:-1]]),
                 jnp.concatenate([jnp.zeros((1,), rdt), d0.im[:-1]]))
        tol1 = cxm.cabs(d0m) + cxm.cabs(d0)
        tol1 = jnp.maximum(ulp * tol1, smlnum)
        neg1 = (cxm.cabs(sub0) <= tol1) & (iv >= 1) & (iv <= ilast)
        any1 = jnp.any(neg1)
        jstar = jnp.max(jnp.where(neg1, iv, -1))
        jlo = jnp.where(any1, jstar, 0)
        split1 = (ilast == 0) | (any1 & (jstar == ilast))
        H = cxm.at_set(H, 0, setel_cx(CX(H.re[0], H.im[0]), jstar, jstar - 1,
                                      cxm.zeros((), rdt), active=any1))

        dl = CX(jnp.diagonal(H.re, axis1=1, axis2=2),
                jnp.diagonal(H.im, axis1=1, axis2=2))
        supre = jnp.concatenate([jnp.diagonal(H.re, 1, 1, 2),
                                 jnp.zeros((p, 1), rdt)], axis=1)
        supim = jnp.concatenate([jnp.diagonal(H.im, 1, 1, 2),
                                 jnp.zeros((p, 1), rdt)], axis=1)
        sup = CX(supre, supim)
        supm1 = CX(jnp.concatenate([jnp.zeros((p, 1), rdt),
                                    sup.re[:, :-1]], axis=1),
                   jnp.concatenate([jnp.zeros((p, 1), rdt),
                                    sup.im[:, :-1]], axis=1))
        toltr = jnp.where(
            iv[None, :] == ilast, cxm.cabs(supm1),
            jnp.where(iv[None, :] == jlo, cxm.cabs(sup),
                      cxm.cabs(supm1) + cxm.cabs(sup)))
        toltr = jnp.maximum(ulp * toltr, smlnum)
        lv = jnp.arange(p, dtype=jnp.int32)
        negtr = (cxm.cabs(dl) <= toltr) & (iv[None, :] >= jlo) & \
                (iv[None, :] <= ilast) & (lv[:, None] >= 1)
        bestj = jnp.max(jnp.where(negtr, iv[None, :], -1), axis=1)
        s_arr = jnp.asarray(S)
        pos_l = jnp.min(jnp.where(s_arr & (bestj >= 0) & (lv >= 1), lv,
                                  p + 1))
        neg_l = jnp.min(jnp.where((~s_arr) & (bestj >= 0) & (lv >= 1), lv,
                                  p + 1))
        has_pos = pos_l <= p
        has_neg = neg_l <= p
        ldef = jnp.where(has_pos, pos_l, neg_l).astype(jnp.int32)
        jdef = bestj[jnp.clip(ldef, 0, p - 1)]

        action = jnp.where(
            split1, 0,
            jnp.where(has_pos, 1,
                      jnp.where(has_neg, 2,
                                jnp.where((ziter >= 7) | (ziter < 0), 3,
                                          4))))

        info = {"jlo": jlo, "ldef": ldef, "jdef": jdef}
        st = (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)
        st = lax.switch(action, [act_split, act_pos, act_neg, act_czshift,
                                 act_sweep], st, info)
        return st, jiter + 1

    def cond(full):
        st, jiter = full
        ilast = st[6]
        return (ilast >= 0) & (jiter < maxit)

    def body_guarded(full):
        st, jiter = full
        return lax.cond(st[6] >= 0, body, lambda f: (f[0], f[1] + 1), full)

    st0 = (H, Z, alr0, ali0, beta0, scal0, jnp.int32(n - 1), jnp.int32(0),
           jnp.int32(ziter0), key0)
    (H, Z, alr, ali, be, sc, ilast, _, _, _), jiter = lax.while_loop(
        cond, body_guarded, (st0, jnp.int32(0)))
    ok = ilast < 0

    # postprocess: real-nonneg triangular diagonals, phases into Z/neighbor
    for l in range(p - 1, 0, -1):
        d = CX(jnp.diagonal(H.re[l]), jnp.diagonal(H.im[l]))
        absd = cxm.cabs(d)
        safe = jnp.where(absd == 0, jnp.ones_like(absd), absd)
        zph = where(absd > safmin,
                    CX(d.re / safe, -d.im / safe),
                    cxm.cx(jnp.ones_like(absd)))
        newdiag = where(absd > safmin, cxm.cx(absd), d)
        Hl = CX(H.re[l], H.im[l])
        if S[l]:
            Hl = CX(zph.re[:, None] * Hl.re - zph.im[:, None] * Hl.im,
                    zph.re[:, None] * Hl.im + zph.im[:, None] * Hl.re)
            sf = zph
        else:
            Hl = CX(Hl.re * zph.re[None, :] - Hl.im * zph.im[None, :],
                    Hl.im * zph.re[None, :] + Hl.re * zph.im[None, :])
            sf = conj(zph)
        Hl = CX(Hl.re - jnp.diag(jnp.diagonal(Hl.re)) + jnp.diag(newdiag.re),
                Hl.im - jnp.diag(jnp.diagonal(Hl.im)) + jnp.diag(newdiag.im))
        H = cxm.at_set(H, l, Hl)
        if want_z:
            sfc = conj(sf)
            Zl = CX(Z.re[l], Z.im[l])
            Zl = CX(Zl.re * sfc.re[None, :] - Zl.im * sfc.im[None, :],
                    Zl.im * sfc.re[None, :] + Zl.re * sfc.im[None, :])
            Z = cxm.at_set(Z, l, Zl)
        lm = l - 1
        Hm = CX(H.re[lm], H.im[lm])
        if S[lm]:
            sfc = conj(sf)
            Hm = CX(Hm.re * sfc.re[None, :] - Hm.im * sfc.im[None, :],
                    Hm.im * sfc.re[None, :] + Hm.re * sfc.im[None, :])
        else:
            Hm = CX(sf.re[:, None] * Hm.re - sf.im[:, None] * Hm.im,
                    sf.re[:, None] * Hm.im + sf.im[:, None] * Hm.re)
        H = cxm.at_set(H, lm, Hm)

    zout = (Z.re, Z.im) if want_z else (None, None)
    out = (H.re, H.im) + zout + (alr, ali, be, sc, ok)
    if with_info:
        return out + ({"niter": jiter, "maxit": jnp.int32(maxit)},)
    return out
