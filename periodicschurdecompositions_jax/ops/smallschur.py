"""Fixed-budget eigenvalues of a small real upper-Hessenberg matrix.

Shift engine for a small-bulge multishift sweep: small-bulge multishift QR
needs the eigenvalues of the TRAILING 2*NB x 2*NB window of
the cycle product as shift pairs (Braman-Byers-Mathias small-bulge
semantics; LAPACK dlaqr0 obtains them the same way via dlahqr on the
window).  Shifts from disjoint 2x2 diagonal blocks ignore the coupling
between blocks and do not reduce the sweep count; window eigenvalues
do.

This is a masked, fully static-shape Francis double-shift iteration on an
M x M (M <= 8) matrix — jit/while_loop-embeddable, float64.  Reference for
the shift/chase semantics: LAPACK dlahqr as translated at
/root/reference/src/PeriodicSchurDecompositions.jl:729-886 (shift
computation and bulge chase); this is an independent static-shape
re-expression for tiny M.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_TOL = 1e-10  # relative deflation threshold; shift estimates need no more


def _eig2x2(a, b, c, d):
    """Eigenvalues of [[a, b], [c, d]]: (re1, im1, re2, im2), im2 = -im1."""
    s = jnp.abs(a) + jnp.abs(b) + jnp.abs(c) + jnp.abs(d)
    ss = jnp.where(s == 0, 1.0, s)
    an, bn, cn, dn = a / ss, b / ss, c / ss, d / ss
    tc = (an + dn) * 0.5
    disc = ((an - dn) * 0.5) ** 2 + bn * cn
    rt = jnp.sqrt(jnp.abs(disc))
    re1 = jnp.where(disc >= 0, tc + rt, tc) * s
    re2 = jnp.where(disc >= 0, tc - rt, tc) * s
    im1 = jnp.where(disc >= 0, 0.0, rt) * s
    return re1, im1, re2, -im1


def hess_eigs_small(W, niter: int | None = None, return_matrix: bool = False):
    """Eigenvalues (wr, wi) of a small real Hessenberg matrix, in diagonal
    order (a conjugate pair occupies its block's two positions).

    Runs ``niter`` (default ``15 * M``) masked Francis double-shift
    iterations with bottom deflation, then reads eigenvalues positionally
    off the resulting (quasi-)triangular matrix.  Entirely static shapes:
    safe inside jit/while_loop bodies.
    """
    M = W.shape[0]
    f64 = jnp.float64
    W = W.astype(f64)
    if M == 1:
        return W[0, 0][None], jnp.zeros((1,), f64)
    K = (15 * M) if niter is None else niter
    rows = jnp.arange(M)

    def negligible(W):
        # neg[j] == True: subdiagonal W[j, j-1] deflatable (j >= 1)
        d = jnp.abs(jnp.diagonal(W))
        sub = jnp.abs(jnp.concatenate([jnp.zeros((1,), f64),
                                       jnp.diagonal(W, -1)]))
        dsum = d + jnp.concatenate([jnp.zeros((1,), f64), d[:-1]])
        floor = _TOL * jnp.maximum(jnp.max(jnp.abs(W)), 1e-300)
        return sub <= _TOL * dsum + floor

    def body(t, st):
        W, ib, its = st
        neg = negligible(W)

        def g(j0, j1):
            j0 = jnp.clip(j0, 0, M - 1)
            j1 = jnp.clip(j1, 0, M - 1)
            return W[j0, j1]

        # bottom deflation: shrink past converged 1x1 / 2x2 blocks
        negib = jnp.where(ib >= 1, neg[jnp.clip(ib, 0, M - 1)], True)
        negib1 = jnp.where(ib >= 2, neg[jnp.clip(ib - 1, 0, M - 1)], True)
        d1 = (ib >= 1) & negib
        d2 = (~d1) & (ib >= 1) & negib1
        shrink = d1 | d2 | (ib <= 0)
        ibn = jnp.where(d1, ib - 1, jnp.where(d2, ib - 2, ib))

        def sweep(W):
            # sweep start: after the LAST negligible subdiagonal in
            # [1, ib-1] (dlahqr's small-subdiagonal restart)
            jidx = jnp.arange(M)
            cand = neg & (jidx >= 1) & (jidx <= ib - 1)
            lw = jnp.max(jnp.where(cand, jidx, 0))
            # Francis shifts from the trailing 2x2; exceptional every 10
            a = g(ib - 1, ib - 1)
            b = g(ib - 1, ib)
            c = g(ib, ib - 1)
            d = g(ib, ib)
            exc = (its > 0) & (its % 10 == 0)
            sE = jnp.abs(c) + jnp.abs(g(ib - 1, ib - 2))
            aE = 0.75 * sE + d
            bE = -0.4375 * sE
            cE = sE
            dE = aE
            a = jnp.where(exc, aE, a)
            b = jnp.where(exc, bE, b)
            c = jnp.where(exc, cE, c)
            d = jnp.where(exc, dE, d)
            s1r, s1i, s2r, _ = _eig2x2(a, b, c, d)

            # first column of (W - s1)(W - s2) e_lw  (rows lw..lw+2)
            h11 = g(lw, lw)
            h12 = g(lw, lw + 1)
            h21 = g(lw + 1, lw)
            h22 = g(lw + 1, lw + 1)
            h32 = jnp.where(lw + 2 <= ib, g(lw + 2, lw + 1), 0.0)
            sv = jnp.abs(h11 - s2r) + jnp.abs(s1i) + jnp.abs(h21)
            svs = jnp.where(sv == 0, 1.0, sv)
            h21s = h21 / svs
            v0 = h21s * h12 + (h11 - s1r) * ((h11 - s2r) / svs) + \
                s1i * (s1i / svs)
            v1 = h21s * (h11 + h22 - s1r - s2r)
            v2 = h21s * h32

            def chase_step(W, k, x):
                # 3x3 reflector from x (masked 2x2 at k == ib-1)
                three = k <= ib - 2
                x = jnp.where(jnp.arange(3) < jnp.where(three, 3, 2),
                              x, 0.0)
                nx = jnp.sqrt(jnp.sum(x * x))
                al = x[0]
                beta = -jnp.where(al >= 0, nx, -nx)
                safe = nx > 0
                betas = jnp.where(safe, beta, 1.0)
                v = x.at[0].add(-betas)
                vn2 = jnp.sum(v * v)
                tau = jnp.where(safe & (vn2 > 0), 2.0 / vn2, 0.0)
                rmask = ((rows >= k) & (rows <= k + 2) &
                         (rows - k < jnp.where(three, 3, 2)))
                vfull = lax.dynamic_update_slice(
                    jnp.zeros((M + 2,), f64), v, (jnp.clip(k, 0, M - 1),)
                )[:M] * jnp.where(rmask, 1.0, 0.0)
                wrow = vfull @ W                      # v^T W
                W = W - tau * vfull[:, None] * wrow[None, :]
                wcol = W @ vfull                      # W v
                W = W - tau * wcol[:, None] * vfull[None, :]
                return W

            def kbody(k0, Wc):
                k = lw + k0
                act = k <= ib - 1

                def gc(j0, j1):
                    # read the CURRENT carry, not the sweep-entry matrix
                    return Wc[jnp.clip(j0, 0, M - 1), jnp.clip(j1, 0, M - 1)]

                x = jnp.where(
                    k0 == 0,
                    jnp.stack([v0, v1, v2]),
                    jnp.stack([gc(k, k - 1), gc(k + 1, k - 1),
                               jnp.where(k + 2 <= ib, gc(k + 2, k - 1),
                                         0.0)]))
                Wn = chase_step(Wc, k, x)
                return jnp.where(act, Wn, Wc)

            W = lax.fori_loop(0, M - 1, kbody, W)
            # restore exact Hessenberg zeros below the first subdiagonal
            cols = jnp.arange(M)
            W = jnp.where(rows[:, None] > cols[None, :] + 1, 0.0, W)
            return W

        Wn = lax.cond(shrink, lambda W: W, sweep, W)
        # zero the subdiagonal we just deflated across
        Wn = jnp.where(
            shrink & (ibn < ib),
            Wn * (1.0 - ((rows[:, None] == ibn + 1) &
                         (jnp.arange(M)[None, :] == ibn))),
            Wn)
        its = jnp.where(shrink, jnp.int32(0), its + 1)
        return (Wn, jnp.where(shrink, ibn, ib), its)

    W, ibf, _ = lax.fori_loop(0, K, body, (W, jnp.int32(M - 1), jnp.int32(0)))

    # positional readout: 2x2 blocks where the subdiagonal survived
    d = jnp.abs(jnp.diagonal(W))
    subs = jnp.abs(jnp.diagonal(W, -1))
    dsum = d[:-1] + d[1:]
    floor = _TOL * jnp.maximum(jnp.max(jnp.abs(W)), 1e-300)
    t = subs > _TOL * dsum + floor          # t[j]: block starts at j
    t = jnp.concatenate([t, jnp.zeros((1,), bool)])
    prev = jnp.concatenate([jnp.zeros((1,), bool), t[:-1]])
    start2 = t & ~prev
    second = prev  # j is the second member iff a block starts at j-1

    a = jnp.diagonal(W)
    bshift = jnp.concatenate([jnp.diagonal(W, 1), jnp.zeros((1,), f64)])
    cshift = jnp.concatenate([jnp.diagonal(W, -1), jnp.zeros((1,), f64)])
    dshift = jnp.concatenate([a[1:], jnp.zeros((1,), f64)])
    re1, im1, re2, im2 = jax.vmap(_eig2x2)(a, bshift, cshift, dshift)
    re1p = jnp.concatenate([jnp.zeros((1,), f64), re1[:-1]])
    im2p = jnp.concatenate([jnp.zeros((1,), f64), im2[:-1]])
    re2p = jnp.concatenate([jnp.zeros((1,), f64), re2[:-1]])
    wr = jnp.where(start2, re1, jnp.where(second, re2p, a))
    wi = jnp.where(start2, im1, jnp.where(second, im2p, 0.0))
    if return_matrix:
        return wr, wi, W, ibf
    return wr, wi
