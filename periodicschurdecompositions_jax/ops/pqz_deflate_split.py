"""Split-complex fork of ops/pqz_deflate.py (no complex dtype).

Identical algorithm and masking structure as pqz_deflate.make_deflate_cores
(reference src/generalized.jl:453-566 deflate_pos, :568-740 deflate_neg,
:356-448 controlled zero shift); every complex value is a cxkern.CX
(re, im) float64 pair.  Tests cross-validate it against the complex128
original.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from . import cxkern as cxm
from .cxkern import (CX, colsk_cx, fac_get, fac_set, getel_cx, givens_cx,
                     lmat_cx, neg, rmat_adj_cx, rowsk_cx, setel_cx, where)


def make_deflate_cores_split(*, p, n, S, rdt, want_z, ulp, smlnum):
    S_arr = jnp.asarray(S)
    zero_c = cxm.zeros((), rdt)

    def vget(G: CX, k) -> CX:
        k = jnp.clip(jnp.asarray(k, jnp.int32), 0, n - 1)
        return CX(lax.dynamic_slice(G.re, (k,), (1,))[0],
                  lax.dynamic_slice(G.im, (k,), (1,))[0])

    def vset(G: CX, k, val: CX, act) -> CX:
        old = vget(G, k)
        v = where(act, val, old)
        k = jnp.clip(jnp.asarray(k, jnp.int32), 0, n - 1)
        return CX(lax.dynamic_update_slice(G.re, v.re[None], (k,)),
                  lax.dynamic_update_slice(G.im, v.im[None], (k,)))

    def rset(Gc, k, val, act):
        k = jnp.clip(jnp.asarray(k, jnp.int32), 0, n - 1)
        old = lax.dynamic_slice(Gc, (k,), (1,))[0]
        return lax.dynamic_update_slice(
            Gc, jnp.where(act, val, old)[None], (k,))

    def zup(Z, l, base, c, s: CX):
        if not want_z:
            return Z
        return fac_set(Z, jnp.int32(l),
                       colsk_cx(fac_get(Z, jnp.int32(l)), base,
                                rmat_adj_cx(c, s)))

    def zup_dyn(Z, l, base, c, s: CX):
        if not want_z:
            return Z
        Zl = fac_get(Z, l)
        Zl = colsk_cx(Zl, base, rmat_adj_cx(c, s))
        return fac_set(Z, l, Zl)

    def chain_right_static(M: CX, Gc, Gs: CX, klo, khi) -> CX:
        def bd(k, M):
            act = (k >= klo) & (k <= khi)
            return colsk_cx(M, k, rmat_adj_cx(Gc[k], vget(Gs, k)), active=act)
        return lax.fori_loop(0, n - 1, bd, M)

    def chain_right_desc(M: CX, Gc, Gs: CX, klo, khi) -> CX:
        def bd(t, M):
            k = khi - t
            act = k >= klo
            return colsk_cx(M, k - 1, rmat_adj_cx(Gc[jnp.clip(k, 0, n - 1)],
                                                  vget(Gs, k)), active=act)
        return lax.fori_loop(0, n, bd, M)

    # =====================================================================
    # DEFLATE_POS (reference src/generalized.jl:453-566)
    def pos_core(H: CX, Z: CX, jlo, ldef, jdef, ilast):
        Hl = fac_get(H, ldef)
        Hl = setel_cx(Hl, jdef, jdef, zero_c)
        H = fac_set(H, ldef, Hl)

        Gc = jnp.ones((n,), rdt)
        Gs = cxm.zeros((n,), rdt)

        def a1(k, carry):
            H0, Gc, Gs = carry
            act = (k >= jlo) & (k <= jdef - 1)
            c, s, r = givens_cx(getel_cx(H0, k, k), getel_cx(H0, k + 1, k))
            H0 = setel_cx(H0, k, k, r, active=act)
            H0 = setel_cx(H0, k + 1, k, zero_c, active=act)
            H0 = rowsk_cx(H0, k, lmat_cx(c, s), lo=k + 1, active=act)
            Gc = rset(Gc, k, c, act)
            Gs = vset(Gs, k, s, act)
            return H0, Gc, Gs

        H0, Gc, Gs = lax.fori_loop(0, n - 1, a1, (fac_get(H, 0), Gc, Gs))
        H = fac_set(H, 0, H0)
        if want_z:
            Z = fac_set(Z, 0, chain_right_static(fac_get(Z, 0), Gc, Gs,
                                                 jlo, jdef - 1))

        for l in range(p - 1, 0, -1):
            ntra = jnp.where(l < ldef, jdef - 2, jdef - 1)
            if S[l]:
                def b1(k, carry, l=l, ntra=ntra):
                    Hl, Gc, Gs = carry
                    act = (k >= jlo) & (k <= ntra)
                    Hl = colsk_cx(Hl, k, rmat_adj_cx(Gc[k], vget(Gs, k)),
                                  hi=k + 2, active=act)
                    c, s, r = givens_cx(getel_cx(Hl, k, k),
                                        getel_cx(Hl, k + 1, k))
                    Hl = setel_cx(Hl, k, k, r, active=act)
                    Hl = setel_cx(Hl, k + 1, k, zero_c, active=act)
                    Hl = rowsk_cx(Hl, k, lmat_cx(c, s), lo=k + 1, active=act)
                    Gc = rset(Gc, k, c, act)
                    Gs = vset(Gs, k, s, act)
                    return Hl, Gc, Gs
            else:
                def b1(k, carry, l=l, ntra=ntra):
                    Hl, Gc, Gs = carry
                    act = (k >= jlo) & (k <= ntra)
                    Hl = rowsk_cx(Hl, k, lmat_cx(Gc[k], vget(Gs, k)), lo=k,
                                  active=act)
                    c, s, r = givens_cx(getel_cx(Hl, k + 1, k + 1),
                                        getel_cx(Hl, k + 1, k))
                    Hl = setel_cx(Hl, k + 1, k + 1, r, active=act)
                    Hl = setel_cx(Hl, k + 1, k, zero_c, active=act)
                    Hl = colsk_cx(Hl, k, lmat_cx(c, s), hi=k + 1, active=act)
                    Gc = rset(Gc, k, c, act)
                    Gs = vset(Gs, k, neg(s), act)
                    return Hl, Gc, Gs

            Hl, Gc, Gs = lax.fori_loop(0, n - 1, b1, (fac_get(H, l), Gc, Gs))
            H = fac_set(H, l, Hl)
            if want_z:
                Z = fac_set(Z, l, chain_right_static(fac_get(Z, l), Gc, Gs,
                                                     jlo, ntra))

        def c1(k, H0):
            act = (k >= jlo) & (k <= jdef - 2)
            return colsk_cx(H0, k, rmat_adj_cx(Gc[k], vget(Gs, k)),
                            hi=k + 2, active=act)

        H = fac_set(H, 0, lax.fori_loop(0, n - 1, c1, fac_get(H, 0)))

        # ---- second unshifted half-sweep (upwards from ilast) ----------
        G2c = jnp.ones((n,), rdt)
        G2s = cxm.zeros((n,), rdt)

        def a2(t, carry):
            H0, G2c, G2s = carry
            j = ilast - t
            act = j >= jdef + 1
            c, s, r = givens_cx(getel_cx(H0, j, j), getel_cx(H0, j, j - 1))
            H0 = setel_cx(H0, j, j, r, active=act)
            H0 = setel_cx(H0, j, j - 1, zero_c, active=act)
            H0 = colsk_cx(H0, j - 1, lmat_cx(c, s), hi=j, active=act)
            G2c = rset(G2c, j, c, act)
            G2s = vset(G2s, j, neg(s), act)
            return H0, G2c, G2s

        H0, G2c, G2s = lax.fori_loop(0, n, a2, (fac_get(H, 0), G2c, G2s))
        H = fac_set(H, 0, H0)
        if want_z:
            Z = fac_set(Z, 1 % p, chain_right_desc(fac_get(Z, 1 % p),
                                                   G2c, G2s,
                                                   jdef + 1, ilast))

        for l in range(1, p):
            ntra = jnp.where(l > ldef, jdef + 2, jdef + 1)
            if not S[l]:
                def b2(t, carry, l=l, ntra=ntra):
                    Hl, G2c, G2s = carry
                    j = ilast - t
                    act = j >= ntra
                    Hl = colsk_cx(Hl, j - 1,
                                  rmat_adj_cx(G2c[jnp.clip(j, 0, n - 1)],
                                              vget(G2s, j)),
                                  hi=j + 1, active=act)
                    c, s, r = givens_cx(getel_cx(Hl, j - 1, j - 1),
                                        getel_cx(Hl, j, j - 1))
                    Hl = setel_cx(Hl, j - 1, j - 1, r, active=act)
                    Hl = setel_cx(Hl, j, j - 1, zero_c, active=act)
                    Hl = rowsk_cx(Hl, j - 1, lmat_cx(c, s), lo=j, active=act)
                    G2c = rset(G2c, j, c, act)
                    G2s = vset(G2s, j, s, act)
                    return Hl, G2c, G2s
            else:
                def b2(t, carry, l=l, ntra=ntra):
                    Hl, G2c, G2s = carry
                    j = ilast - t
                    act = j >= ntra
                    Hl = rowsk_cx(Hl, j - 1,
                                  lmat_cx(G2c[jnp.clip(j, 0, n - 1)],
                                          vget(G2s, j)),
                                  lo=j - 1, active=act)
                    c, s, r = givens_cx(getel_cx(Hl, j, j),
                                        getel_cx(Hl, j, j - 1))
                    Hl = setel_cx(Hl, j, j, r, active=act)
                    Hl = setel_cx(Hl, j, j - 1, zero_c, active=act)
                    Hl = colsk_cx(Hl, j - 1, lmat_cx(c, s), hi=j, active=act)
                    G2c = rset(G2c, j, c, act)
                    G2s = vset(G2s, j, neg(s), act)
                    return Hl, G2c, G2s

            Hl, G2c, G2s = lax.fori_loop(0, n, b2, (fac_get(H, l), G2c, G2s))
            H = fac_set(H, l, Hl)
            if want_z:
                Z = fac_set(Z, (l + 1) % p,
                            chain_right_desc(fac_get(Z, (l + 1) % p),
                                             G2c, G2s, ntra, ilast))

        def c2(t, H0):
            j = ilast - t
            act = j >= jdef + 2
            return rowsk_cx(H0, j - 1,
                            lmat_cx(G2c[jnp.clip(j, 0, n - 1)], vget(G2s, j)),
                            lo=j - 1, active=act)

        H = fac_set(H, 0, lax.fori_loop(0, n, c2, fac_get(H, 0)))
        return H, Z

    # =====================================================================
    # DEFLATE_NEG ring-walk branch bodies
    def hess_dn(op):
        Hln, j, c, s = op
        Hln = rowsk_cx(Hln, j, lmat_cx(c, s), lo=j - 1)
        cn, sn, r = givens_cx(getel_cx(Hln, j + 1, j),
                              getel_cx(Hln, j + 1, j - 1))
        Hln = setel_cx(Hln, j + 1, j, r)
        Hln = setel_cx(Hln, j + 1, j - 1, zero_c)
        Hln = colsk_cx(Hln, j - 1, lmat_cx(cn, sn), hi=j + 1)
        return Hln, j - 1, cn, neg(sn)

    def pos_dn(op):
        Hln, j, c, s = op
        Hln = rowsk_cx(Hln, j, lmat_cx(c, s), lo=j)
        cn, sn, r = givens_cx(getel_cx(Hln, j + 1, j + 1),
                              getel_cx(Hln, j + 1, j))
        Hln = setel_cx(Hln, j + 1, j + 1, r)
        Hln = setel_cx(Hln, j + 1, j, zero_c)
        Hln = colsk_cx(Hln, j, lmat_cx(cn, sn), hi=j + 1)
        return Hln, j, cn, neg(sn)

    def neg_dn(op):
        Hln, j, c, s = op
        Hln = colsk_cx(Hln, j, rmat_adj_cx(c, s), hi=j + 2)
        cn, sn, r = givens_cx(getel_cx(Hln, j, j), getel_cx(Hln, j + 1, j))
        Hln = setel_cx(Hln, j, j, r)
        Hln = setel_cx(Hln, j + 1, j, zero_c)
        Hln = rowsk_cx(Hln, j, lmat_cx(cn, sn), lo=j + 1)
        return Hln, j, cn, sn

    def hess_up(op):
        Hln, j, c, s = op
        Hln = colsk_cx(Hln, j - 1, rmat_adj_cx(c, s), hi=j + 2)
        cn, sn, r = givens_cx(getel_cx(Hln, j, j - 1),
                              getel_cx(Hln, j + 1, j - 1))
        Hln = setel_cx(Hln, j, j - 1, r)
        Hln = setel_cx(Hln, j + 1, j - 1, zero_c)
        Hln = rowsk_cx(Hln, j, lmat_cx(cn, sn), lo=j)
        return Hln, j + 1, cn, sn

    def neg_up(op):
        Hln, j, c, s = op
        Hln = rowsk_cx(Hln, j - 1, lmat_cx(c, s), lo=j - 1)
        cn, sn, r = givens_cx(getel_cx(Hln, j, j), getel_cx(Hln, j, j - 1))
        Hln = setel_cx(Hln, j, j, r)
        Hln = setel_cx(Hln, j, j - 1, zero_c)
        Hln = colsk_cx(Hln, j - 1, lmat_cx(cn, sn), hi=j)
        return Hln, j, cn, neg(sn)

    def pos_up(op):
        Hln, j, c, s = op
        Hln = colsk_cx(Hln, j - 1, rmat_adj_cx(c, s), hi=j + 1)
        cn, sn, r = givens_cx(getel_cx(Hln, j - 1, j - 1),
                              getel_cx(Hln, j, j - 1))
        Hln = setel_cx(Hln, j - 1, j - 1, r)
        Hln = setel_cx(Hln, j, j - 1, zero_c)
        Hln = rowsk_cx(Hln, j - 1, lmat_cx(cn, sn), lo=j)
        return Hln, j, cn, sn

    def neg_core(H: CX, Z: CX, jlo, ldef, jdef, ilast):
        Hl = fac_get(H, ldef)
        Hl = setel_cx(Hl, jdef, jdef, zero_c)
        H = fac_set(H, ldef, Hl)

        bottom = (jdef + 1).astype(rdt) > (ilast - jlo + 1).astype(rdt) / 2

        def chase_down(HZ):
            H, Z = HZ

            def outer(j1, HZ):
                H, Z = HZ

                def run(HZ):
                    H, Z = HZ
                    j = j1
                    Hl = fac_get(H, ldef)
                    c, s, r = givens_cx(getel_cx(Hl, j, j + 1),
                                        getel_cx(Hl, j + 1, j + 1))
                    Hl = setel_cx(Hl, j, j + 1, r)
                    Hl = setel_cx(Hl, j + 1, j + 1, zero_c)
                    Hl = rowsk_cx(Hl, j, lmat_cx(c, s), lo=j + 2)
                    H = fac_set(H, ldef, Hl)
                    ln = (ldef + 1) % p
                    Z = zup_dyn(Z, ln, j, c, s)

                    def step(t, carry):
                        H, Z, j, c, s, ln = carry
                        Hln = fac_get(H, ln)
                        bidx = jnp.where(ln == 0, 0,
                                         jnp.where(S_arr[ln], 1, 2))
                        Hln, j, c, s = lax.switch(
                            bidx, [hess_dn, pos_dn, neg_dn], (Hln, j, c, s))
                        H = fac_set(H, ln, Hln)
                        ln = (ln + 1) % p
                        Z = zup_dyn(Z, ln, j, c, s)
                        return H, Z, j, c, s, ln

                    H, Z, j, c, s, ln = lax.fori_loop(
                        0, p - 1, step, (H, Z, j, c, s, ln))
                    Hl = fac_get(H, ldef)
                    Hl = colsk_cx(Hl, j, rmat_adj_cx(c, s), hi=j + 1)
                    H = fac_set(H, ldef, Hl)
                    return H, Z

                act = (j1 >= jdef) & (j1 <= ilast - 1)
                return lax.cond(act, run, lambda x: x, (H, Z))

            H, Z = lax.fori_loop(0, n, outer, (H, Z))

            j = ilast
            H0 = fac_get(H, 0)
            c, s, r = givens_cx(getel_cx(H0, j, j), getel_cx(H0, j, j - 1))
            H0 = setel_cx(H0, j, j, r)
            H0 = setel_cx(H0, j, j - 1, zero_c)
            H0 = colsk_cx(H0, j - 1, lmat_cx(c, s), hi=j)
            H = fac_set(H, 0, H0)
            c2, s2 = c, neg(s)
            Z = zup(Z, 1 % p, j - 1, c2, s2)
            for l in range(1, p):
                act = l < ldef

                def run2(HZcs, l=l):
                    H, Z, c2, s2 = HZcs
                    Hl = fac_get(H, jnp.int32(l))
                    if not S[l]:
                        Hl = colsk_cx(Hl, j - 1, rmat_adj_cx(c2, s2),
                                      hi=j + 1)
                        cn, sn, r = givens_cx(getel_cx(Hl, j - 1, j - 1),
                                              getel_cx(Hl, j, j - 1))
                        Hl = setel_cx(Hl, j - 1, j - 1, r)
                        Hl = setel_cx(Hl, j, j - 1, zero_c)
                        Hl = rowsk_cx(Hl, j - 1, lmat_cx(cn, sn), lo=j)
                        cf, sf = cn, sn
                    else:
                        Hl = rowsk_cx(Hl, j - 1, lmat_cx(c2, s2), lo=j - 1)
                        cn, sn, r = givens_cx(getel_cx(Hl, j, j),
                                              getel_cx(Hl, j, j - 1))
                        Hl = setel_cx(Hl, j, j, r)
                        Hl = setel_cx(Hl, j, j - 1, zero_c)
                        Hl = colsk_cx(Hl, j - 1, lmat_cx(cn, sn), hi=j)
                        cf, sf = cn, neg(sn)
                    H = fac_set(H, jnp.int32(l), Hl)
                    Z = zup(Z, (l + 1) % p, j - 1, cf, sf)
                    return H, Z, cf, sf

                H, Z, c2, s2 = lax.cond(act, run2, lambda x: x,
                                        (H, Z, c2, s2))
            Hl = fac_get(H, ldef)
            Hl = colsk_cx(Hl, j - 1, rmat_adj_cx(c2, s2), hi=j + 1)
            H = fac_set(H, ldef, Hl)
            return H, Z

        def chase_up(HZ):
            H, Z = HZ

            def outer(t, HZ):
                H, Z = HZ
                j1 = jdef - t

                def run(HZ):
                    H, Z = HZ
                    j = j1
                    Hl = fac_get(H, ldef)
                    c, s, r = givens_cx(getel_cx(Hl, j - 1, j),
                                        getel_cx(Hl, j - 1, j - 1))
                    Hl = setel_cx(Hl, j - 1, j, r)
                    Hl = setel_cx(Hl, j - 1, j - 1, zero_c)
                    Hl = colsk_cx(Hl, j - 1, lmat_cx(c, s), hi=j - 1)
                    H = fac_set(H, ldef, Hl)
                    c, s = c, neg(s)
                    Z = zup_dyn(Z, ldef, j - 1, c, s)
                    ln = (ldef - 1) % p

                    def step(t2, carry):
                        H, Z, j, c, s, ln = carry
                        Hln = fac_get(H, ln)
                        bidx = jnp.where(ln == 0, 0,
                                         jnp.where(S_arr[ln], 1, 2))
                        Hln, j, c, s = lax.switch(
                            bidx, [hess_up, pos_up, neg_up], (Hln, j, c, s))
                        H = fac_set(H, ln, Hln)
                        Z = zup_dyn(Z, ln, j - 1, c, s)
                        ln = (ln - 1) % p
                        return H, Z, j, c, s, ln

                    H, Z, j, c, s, ln = lax.fori_loop(
                        0, p - 1, step, (H, Z, j, c, s, ln))
                    Hl = fac_get(H, ldef)
                    Hl = rowsk_cx(Hl, j - 1, lmat_cx(c, s), lo=j)
                    H = fac_set(H, ldef, Hl)
                    return H, Z

                act = (j1 >= jlo + 1) & (j1 <= jdef)
                return lax.cond(act, run, lambda x: x, (H, Z))

            H, Z = lax.fori_loop(0, n, outer, (H, Z))

            j = jlo
            H0 = fac_get(H, 0)
            c, s, r = givens_cx(getel_cx(H0, j, j), getel_cx(H0, j + 1, j))
            H0 = setel_cx(H0, j, j, r)
            H0 = setel_cx(H0, j + 1, j, zero_c)
            H0 = rowsk_cx(H0, j, lmat_cx(c, s), lo=j + 1)
            H = fac_set(H, 0, H0)
            c2, s2 = c, s
            Z = zup(Z, 0, j, c2, s2)
            for l in range(p - 1, 0, -1):
                act = l > ldef

                def run2(HZcs, l=l):
                    H, Z, c2, s2 = HZcs
                    Hl = fac_get(H, jnp.int32(l))
                    if S[l]:
                        Hl = colsk_cx(Hl, j, rmat_adj_cx(c2, s2), hi=j + 2)
                        cn, sn, r = givens_cx(getel_cx(Hl, j, j),
                                              getel_cx(Hl, j + 1, j))
                        Hl = setel_cx(Hl, j, j, r)
                        Hl = setel_cx(Hl, j + 1, j, zero_c)
                        Hl = rowsk_cx(Hl, j, lmat_cx(cn, sn), lo=j + 1)
                        cf, sf = cn, sn
                    else:
                        Hl = rowsk_cx(Hl, j, lmat_cx(c2, s2), lo=j)
                        cn, sn, r = givens_cx(getel_cx(Hl, j + 1, j + 1),
                                              getel_cx(Hl, j + 1, j))
                        Hl = setel_cx(Hl, j + 1, j + 1, r)
                        Hl = setel_cx(Hl, j + 1, j, zero_c)
                        Hl = colsk_cx(Hl, j, lmat_cx(cn, sn), hi=j + 1)
                        cf, sf = cn, neg(sn)
                    H = fac_set(H, jnp.int32(l), Hl)
                    Z = zup(Z, l, j, cf, sf)
                    return H, Z, cf, sf

                H, Z, c2, s2 = lax.cond(act, run2, lambda x: x,
                                        (H, Z, c2, s2))
            Hl = fac_get(H, ldef)
            Hl = rowsk_cx(Hl, j, lmat_cx(c2, s2), lo=j + 1)
            H = fac_set(H, ldef, Hl)
            return H, Z

        H, Z = lax.cond(bottom, chase_down, chase_up, (H, Z))
        return H, Z

    # =====================================================================
    # controlled zero shift
    def czshift_core(H: CX, Z: CX, jlo, ilast):
        def stage_a(k, carry):
            H0, Gc, Gs = carry
            act = (k >= jlo) & (k <= ilast - 1)
            f = getel_cx(H0, k, k)
            g = getel_cx(H0, k + 1, k)
            c, s, r = givens_cx(f, g)
            H0 = setel_cx(H0, k, k, r, active=act)
            H0 = setel_cx(H0, k + 1, k, zero_c, active=act)
            H0 = rowsk_cx(H0, k, lmat_cx(c, s), lo=k + 1, active=act)
            Gc = rset(Gc, k, c, act)
            Gs = vset(Gs, k, s, act)
            return H0, Gc, Gs

        Gc = jnp.ones((n,), rdt)
        Gs = cxm.zeros((n,), rdt)
        H0, Gc, Gs = lax.fori_loop(0, n - 1, stage_a, (fac_get(H, 0), Gc, Gs))
        H = fac_set(H, 0, H0)

        def chain_right(M: CX, Gc, Gs: CX, klo, khi) -> CX:
            def body(k, M):
                act = (k >= klo) & (k <= khi)
                return colsk_cx(M, k, rmat_adj_cx(Gc[k], vget(Gs, k)),
                                active=act)
            return lax.fori_loop(0, n - 1, body, M)

        if want_z:
            Z = fac_set(Z, 0, chain_right(fac_get(Z, 0), Gc, Gs,
                                          jlo, ilast - 1))

        for l in range(p - 1, 0, -1):
            if S[l]:
                def stage_b_pos(k, carry):
                    Hl, Gc, Gs = carry
                    sk = vget(Gs, k)
                    act = (k >= jlo) & (k <= ilast - 1) & (~cxm.is0(sk))
                    Hl = colsk_cx(Hl, k, rmat_adj_cx(Gc[k], sk), hi=k + 2,
                                  active=act)
                    tol = cxm.cabs(getel_cx(Hl, k, k)) + \
                        cxm.cabs(getel_cx(Hl, k + 1, k + 1))
                    tol = jnp.maximum(ulp * tol, smlnum)
                    negl = cxm.cabs(getel_cx(Hl, k + 1, k)) <= tol
                    f = getel_cx(Hl, k, k)
                    g = getel_cx(Hl, k + 1, k)
                    c, s, r = givens_cx(f, g)
                    use = act & (~negl)
                    Hl = setel_cx(Hl, k, k, r, active=use)
                    Hl = setel_cx(Hl, k + 1, k, zero_c, active=act)
                    Hl = rowsk_cx(Hl, k, lmat_cx(c, s), lo=k + 1, active=use)
                    cnew = jnp.where(negl, jnp.ones((), rdt), c)
                    snew = where(negl, cxm.zeros((), rdt), s)
                    Gc = rset(Gc, k, cnew, act)
                    Gs = vset(Gs, k, snew, act)
                    return Hl, Gc, Gs

                Hl, Gc, Gs = lax.fori_loop(0, n - 1, stage_b_pos,
                                           (fac_get(H, l), Gc, Gs))
            else:
                def stage_b_neg(k, carry):
                    Hl, Gc, Gs = carry
                    sk = vget(Gs, k)
                    act = (k >= jlo) & (k <= ilast - 1) & (~cxm.is0(sk))
                    Hl = rowsk_cx(Hl, k, lmat_cx(Gc[k], sk), lo=k, active=act)
                    tol = cxm.cabs(getel_cx(Hl, k, k)) + \
                        cxm.cabs(getel_cx(Hl, k + 1, k + 1))
                    tol = jnp.maximum(ulp * tol, smlnum)
                    negl = cxm.cabs(getel_cx(Hl, k + 1, k)) <= tol
                    f = getel_cx(Hl, k + 1, k + 1)
                    g = getel_cx(Hl, k + 1, k)
                    c, s, r = givens_cx(f, g)
                    use = act & (~negl)
                    Hl = setel_cx(Hl, k + 1, k + 1, r, active=use)
                    Hl = setel_cx(Hl, k + 1, k, zero_c, active=act)
                    Hl = colsk_cx(Hl, k, lmat_cx(c, s), hi=k + 1, active=use)
                    cnew = jnp.where(negl, jnp.ones((), rdt), c)
                    snew = where(negl, cxm.zeros((), rdt), neg(s))
                    Gc = rset(Gc, k, cnew, act)
                    Gs = vset(Gs, k, snew, act)
                    return Hl, Gc, Gs

                Hl, Gc, Gs = lax.fori_loop(0, n - 1, stage_b_neg,
                                           (fac_get(H, l), Gc, Gs))
            H = fac_set(H, l, Hl)
            if want_z:
                Z = fac_set(Z, l, chain_right(fac_get(Z, l), Gc, Gs,
                                              jlo, ilast - 1))

        def stage_c(k, carry):
            H0, zflag = carry
            act = (k >= jlo) & (k <= ilast - 1)
            sk = vget(Gs, k)
            H0 = colsk_cx(H0, k, rmat_adj_cx(Gc[k], sk), hi=k + 2, active=act)
            zflag = zflag | (act & cxm.is0(sk))
            return H0, zflag

        H0, zflag = lax.fori_loop(0, n - 1, stage_c,
                                  (fac_get(H, 0), jnp.asarray(False)))
        H = fac_set(H, 0, H0)
        return H, Z, zflag

    return pos_core, neg_core, czshift_core
