"""Real generalized periodic Schur core (periodic QZ with signatures).

Behavioral contract from the reference's real `pschur!`
(src/rgeneralized.jl:49-1083, MB03BD semantics): quasi-triangularize the
Hessenberg factor of a signed cycle, keeping 2x2 blocks for complex pairs,
with eigenvalues in decomposed ``alpha/beta * 2^scale`` form.

Shares the deflation framework (tests 1-4, singular-factor deflations,
controlled zero shift) with the complex core via
:mod:`.pqz_deflate.make_deflate_cores`.  Real-specific machinery:

* the double-implicit-shift sweep with two Givens rotations per step and
  per-factor re-triangularization (reference :888-1054),
* the trailing 2x2 block attack: a real single-shift 2x2 periodic QZ
  (`rp2x2ssr`, MB03BF semantics, reference src/rpschur2x2.jl:280-317) tries
  to split two real eigenvalues with a perfect shift; otherwise the block is
  accepted as a complex-pair 2x2 (reference :661-790).

Documented re-design (replacing the reference's MB03AF/MB03AB
rotation cascades, whose Julia translations carry PUZZLE/CHECKME zones and
an undefined-variable branch in `_shift2rot`):

* shifts are the eigenvalues of the EXACT trailing 2x2 of the cyclically
  rotated product ``ℍ₁ = H1^±···Hp-1^± H0`` — exact because triangularity
  confines the trailing block to the window-block product — accumulated as
  a scaled (mantissa, exponent) 2x2 product;
* the opening double-shift rotations come from the first 3 components of
  ``(ℍ₁ - λ1)(ℍ₁ - λ2) e1``, computed exactly from scaled leading 3x3
  window-block products (inverting 3x3 triangular blocks for inverted
  factors), with exponent-clamped shift coefficients;
* 2x2 block eigenvalues come from the scaled signed product of the window
  blocks standardized by dlanv2 (exact conjugate pairs by construction),
  rather than the iterative MB03BB scheme.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..types import ConvergenceFailure, GeneralizedPeriodicSchur
from ..utils.circshift import rev_alias
from ..utils.safeprod import frexp_exp, pow2_scale, safeprod_signed
from .lanv2 import lanv2
from .rotations import (colsk, getcol, getel, getrow, givens_real, lmat,
                        rmat_adj, rowsk, setcol, setel, setrow)


# ---------------------------------------------------------------------------
# 2x2 cycle machinery (C10)


def qzrot2x2(B, S2):
    """Opening rotation for a single-shift 2x2 periodic QZ sweep.

    MB03AF('Single') semantics (reference src/rpschur2x2.jl:1364-1396):
    ``B`` is a (p, 2, 2) block cycle with the (full) Hessenberg block LAST;
    ``S2`` its static signature.  Returns (c, s).
    """
    p = B.shape[0]
    one = jnp.ones((), B.dtype)
    Hl = B[p - 1]
    c1, s1, r = givens_real(Hl[0, 0], Hl[1, 0])
    c2, s2, _ = givens_real(r, one)
    for l in range(p - 2, -1, -1):
        Hl = B[l]
        if S2[l]:
            al = c2 * (c1 * Hl[0, 0] + s1 * Hl[0, 1])
            be = s1 * c2 * Hl[1, 1]
            ga = s2 * Hl[1, 1]
            c1, s1, r = givens_real(al, be)
            c2, s2, _ = givens_real(r, ga)
        else:
            al = c1 * s2 * Hl[0, 0]
            ga = s1 * Hl[0, 0]
            be = s2 * (c1 * Hl[0, 1] + s1 * Hl[1, 1])
            de = c1 * Hl[1, 1] - s1 * Hl[0, 1]
            c1, s1, _ = givens_real(de, ga)
            al = c1 * al + s1 * be
            be = c2 * Hl[1, 1]
            c2, s2, r = givens_real(be, al)
    Hl = B[p - 1]
    al = s2 * Hl[1, 1] - c1 * c2
    be = -s1 * c2
    c1, s1, _ = givens_real(al, be)
    return c1, s1


def rp2x2ssr(B, S2, maxit: int = 40):
    """Real single-shift periodic QZ on a 2x2 block cycle (MB03BF semantics).

    ``B``: (p, 2, 2), Hessenberg block last; returns (B, done) where done
    means the Hessenberg block's subdiagonal became negligible (two real
    eigenvalues).  Reference: src/rpschur2x2.jl:280-317.
    """
    p = B.shape[0]
    dt = B.dtype
    ulp = float(jnp.finfo(dt).eps)

    def body(t, carry):
        B, done = carry

        def step(B):
            c, s = qzrot2x2(B, S2)
            B = B.at[p - 1].set(B[p - 1] @ rmat_adj(c, s).astype(dt))
            for l in range(p - 1):
                Hl = B[l]
                if S2[l]:
                    Hl = lmat(c, s).astype(dt) @ Hl
                    c, s, r = givens_real(Hl[1, 1], -Hl[1, 0])
                    row0 = jnp.stack([c * Hl[0, 0] + s * Hl[0, 1],
                                      c * Hl[0, 1] - s * Hl[0, 0]])
                    Hl = jnp.stack([row0, jnp.stack([jnp.zeros((), dt), r])])
                else:
                    Hl = Hl @ rmat_adj(c, s).astype(dt)
                    c, s, r = givens_real(Hl[0, 0], Hl[1, 0])
                    row0 = jnp.stack([r, c * Hl[0, 1] + s * Hl[1, 1]])
                    row1 = jnp.stack([jnp.zeros((), dt),
                                      c * Hl[1, 1] - s * Hl[0, 1]])
                    Hl = jnp.stack([row0, row1])
                B = B.at[l].set(Hl)
            B = B.at[p - 1].set(lmat(c, s).astype(dt) @ B[p - 1])
            return B

        Bn = step(B)
        B = jax.tree_util.tree_map(lambda a, b: jnp.where(done, a, b), B, Bn)
        Hp = B[p - 1]
        done = done | (jnp.abs(Hp[1, 0]) < ulp * jnp.maximum(
            jnp.maximum(jnp.abs(Hp[0, 0]), jnp.abs(Hp[0, 1])),
            jnp.abs(Hp[1, 1])))
        return B, done

    B, done = lax.fori_loop(0, maxit, body, (B, jnp.asarray(False)))
    return B, done


def _renorm2x2(P, e):
    m = jnp.max(jnp.abs(P))
    ee = frexp_exp(jnp.where(m == 0, jnp.ones_like(m), m))
    k = 1 - ee
    P2 = pow2_scale(P, k)
    e2 = e + ee - 1
    keep = m == 0
    return jnp.where(keep, P, P2), jnp.where(keep, e, e2)


def eig2x2_product(W, S):
    """Eigenvalues of the signed product of a (p, 2, 2) window-block cycle.

    Returns (w1r, w1i, w2r, w2i, scale, beta): eigenvalues are
    ``(wr + i wi) * 2^scale`` (exact conjugates or exact reals via dlanv2);
    beta = 0 flags a singular inverted factor (infinite pair).
    """
    p = W.shape[0]
    dt = W.dtype
    P = jnp.eye(2, dtype=dt)
    e = jnp.zeros((), jnp.int32)
    beta = jnp.ones((), dt)
    for l in range(p):
        Wl = W[l]
        if S[l]:
            P = P @ Wl
        else:
            a, b, d = Wl[0, 0], Wl[0, 1], Wl[1, 1]
            sing = (a == 0) | (d == 0)
            beta = jnp.where(sing, jnp.zeros((), dt), beta)
            asafe = jnp.where(a == 0, jnp.ones((), dt), a)
            dsafe = jnp.where(d == 0, jnp.ones((), dt), d)
            inv = jnp.stack([
                jnp.stack([1.0 / asafe, -b / (asafe * dsafe)]),
                jnp.stack([jnp.zeros((), dt), 1.0 / dsafe])])
            P = P @ inv
        P, e = _renorm2x2(P, e)
    _, _, _, _, _, _, w1r, w1i, w2r, w2i = lanv2(P[0, 0], P[0, 1],
                                                 P[1, 0], P[1, 1])

    def norm_one(wr, wi):
        m = jnp.hypot(wr, wi)
        ee = frexp_exp(jnp.where(m == 0, jnp.ones_like(m), m))
        k = 1 - ee
        keep = m == 0
        sc = jnp.where(keep, jnp.int32(0), ee - 1)
        return (jnp.where(keep, wr, pow2_scale(wr, k)),
                jnp.where(keep, wi, pow2_scale(wi, k)), sc)

    w1r, w1i, s1 = norm_one(w1r, w1i)
    w2r, w2i, s2 = norm_one(w2r, w2i)
    # conjugate pairs have equal magnitude -> equal scales; use s1 for both
    return w1r, w1i, w2r, w2i, s1 + e, s2 + e, beta


# ---------------------------------------------------------------------------
# shift + opening rotations for the double-implicit-shift sweep


def _tri3inv(B):
    """Inverse of an upper-triangular 3x3 (guarded diagonals)."""
    dt = B.dtype
    a, b, c = B[0, 0], B[0, 1], B[0, 2]
    d, ee = B[1, 1], B[1, 2]
    f = B[2, 2]
    a_ = jnp.where(a == 0, jnp.ones((), dt), a)
    d_ = jnp.where(d == 0, jnp.ones((), dt), d)
    f_ = jnp.where(f == 0, jnp.ones((), dt), f)
    i00 = 1.0 / a_
    i11 = 1.0 / d_
    i22 = 1.0 / f_
    i01 = -b / (a_ * d_)
    i12 = -ee / (d_ * f_)
    i02 = (b * ee - c * d) / (a_ * d_ * f_)
    z = jnp.zeros((), dt)
    return jnp.stack([jnp.stack([i00, i01, i02]),
                      jnp.stack([z, i11, i12]),
                      jnp.stack([z, z, i22])])


def _opening_rotations(H, S, j, ilast, key, iiter):
    """Two rotations starting a Francis double-shift sweep on the window.

    See module docstring: Wilkinson shifts from the exact trailing 2x2 of
    the rotated product, opening vector from exact leading 3x3 window-block
    products.  Every 10th iteration uses random exceptional rotations.
    """
    p, _, n = H.shape
    dt = H.dtype

    # leading 3x3 triangular-chain product (factors 1..p-1), scaled
    T3 = jnp.eye(3, dtype=dt)
    eT = jnp.zeros((), jnp.int32)
    for l in range(1, p):
        blk = jnp.triu(lax.dynamic_slice(H[l], (j, j), (3, 3)))
        T3 = T3 @ (blk if S[l] else _tri3inv(blk))
        T3, eT = _renorm2x2(T3, eT)
    H0w = lax.dynamic_slice(H[0], (j, j), (3, 3))
    # guard: the (2,0) entry is outside the Hessenberg band
    H0w = H0w.at[2, 0].set(0.0)
    y1 = T3 @ H0w[:, 0]
    y2 = T3 @ (H0w @ y1)

    # exact trailing 2x2 of the rotated product, scaled
    B2 = jnp.eye(2, dtype=dt)
    eB = jnp.zeros((), jnp.int32)
    it = jnp.asarray(ilast - 1, jnp.int32)
    for l in range(1, p):
        blk = jnp.triu(lax.dynamic_slice(H[l], (it, it), (2, 2)))
        if S[l]:
            B2 = B2 @ blk
        else:
            a, b, d = blk[0, 0], blk[0, 1], blk[1, 1]
            a_ = jnp.where(a == 0, jnp.ones((), dt), a)
            d_ = jnp.where(d == 0, jnp.ones((), dt), d)
            z = jnp.zeros((), dt)
            B2 = B2 @ jnp.stack([jnp.stack([1.0 / a_, -b / (a_ * d_)]),
                                 jnp.stack([z, 1.0 / d_])])
        B2, eB = _renorm2x2(B2, eB)
    B2 = B2 @ lax.dynamic_slice(H[0], (it, it), (2, 2))
    B2, eB = _renorm2x2(B2, eB)
    trc = B2[0, 0] + B2[1, 1]
    det = B2[0, 0] * B2[1, 1] - B2[0, 1] * B2[1, 0]

    d_exp = jnp.clip(eB - eT, -500, 500).astype(dt)
    f = jnp.exp2(d_exp)
    e1v = jnp.zeros((3,), dt).at[0].set(1.0)
    v = y2 - trc * f * y1 + det * f * f * e1v

    c2, s2, r2 = givens_real(v[1], v[2])
    c1, s1, _ = givens_real(v[0], r2)

    # exceptional shift: random rotations every 10 iterations
    key, sub = jax.random.split(key)
    rr = jax.random.normal(sub, (4,), dt)
    ce1, se1, _ = givens_real(rr[0], rr[1])
    ce2, se2, _ = givens_real(rr[2], rr[3])
    exc = (iiter % 10) == 0
    c1 = jnp.where(exc, ce1, c1)
    s1 = jnp.where(exc, se1, s1)
    c2 = jnp.where(exc, ce2, c2)
    s2 = jnp.where(exc, se2, s2)
    return c1, s1, c2, s2, key


# ---------------------------------------------------------------------------
# main core


@partial(jax.jit, static_argnames=("S", "want_z", "maxitfac", "with_info",
                                   "aggressive", "want_t", "return_state"))
def pqz_real_gen_core(
    H: jax.Array,
    S: Tuple[bool, ...],
    Z: Optional[jax.Array] = None,
    want_z: bool = True,
    maxitfac: int = 120,
    seed: int = 1234,
    with_info: bool = False,
    aggressive: bool = False,
    want_t: bool = True,
    it_cap: Optional[jax.Array] = None,
    resume_state=None,
    return_state: bool = False,
):
    """Run the real generalized periodic QZ iteration.

    Args:
      H: (p, n, n) real stack; H[0] upper Hessenberg, H[1:] upper triangular.
      S: static signature tuple, S[0] True; p must be >= 2 (route p == 1 /
         all-positive problems to the plain real core).
      want_t: when False the sweep/attack chains restrict row updates to
        columns <= ilast and column updates to rows >= jlo (the reference's
        ifirstm:ilastm device when !wantT, src/rgeneralized.jl:895-1054);
        eigenvalues are exact, T is only valid on the block diagonal.

    Returns:
      (T, Z, alpha_r, alpha_i, beta, alphascale, ok): T quasi-triangular
      stack (T[0] carries 2x2 blocks for complex pairs).
    """
    p, n, _ = H.shape
    assert S[0], "signature entry S[0] must be True"
    assert p >= 2, "use pqr_real_core for p == 1"
    dt = H.dtype
    rdt = dt
    fi = jnp.finfo(dt)
    ulp = float(fi.eps)
    unfl = float(fi.tiny)
    smlnum = unfl * (n / ulp)
    maxit = maxitfac * n
    ziter0 = -1 if p >= math.log2(fi.tiny) / math.log2(ulp) else 0

    if want_z:
        Zs = jnp.broadcast_to(jnp.eye(n, dtype=dt), (p, n, n)).astype(dt) \
            if Z is None else Z
    else:
        Zs = jnp.zeros((p, 1, 1), dt)

    if n == 1:
        a, b, s = safeprod_signed(H[:, 0, 0], S)
        return (H, Zs if want_z else None, a[None], jnp.zeros((1,), dt),
                b[None], s[None], jnp.asarray(True))

    # aggressive deflation (reference src/rgeneralized.jl:7,54,192-246):
    # the adaptive neighbor-based negligibility tolerances are replaced by a
    # FIXED per-factor threshold max(safmin, ||H[l]||_1 * ulp)
    safmin = unfl
    hnorms_in = jnp.max(jnp.sum(jnp.abs(H), axis=1), axis=1)  # (p,) 1-norms
    agg_tol = jnp.maximum(safmin, hnorms_in * ulp)

    from .pqz_deflate import make_deflate_cores
    pos_core, neg_core, czshift_core = make_deflate_cores(
        p=p, n=n, S=S, dt=dt, rdt=rdt, want_z=want_z, ulp=ulp, smlnum=smlnum)

    iv = jnp.arange(n, dtype=jnp.int32)
    zero = jnp.zeros((), dt)
    key0 = jax.random.PRNGKey(seed)

    def zup(Z, l, k, M, active=None):
        if not want_z:
            return Z
        return Z.at[l].set(colsk(Z[l], k, M, active=active))

    # --- shared "510" single-rotation chain (reference :1020-1048) --------
    # wlo/whi: want_t=False window bounds (rows >= wlo for column updates,
    # columns < whi for row updates); None = unbounded (want_t=True)
    def chain510(H, Z, j, c1, s1, wlo=None, whi=None):
        H = H.at[0].set(rowsk(H[0], j, lmat(c1, s1), lo=j, hi=whi))
        Z = zup(Z, 0, j, rmat_adj(c1, s1))
        for l in range(p - 1, 0, -1):
            Hl = H[l]
            if S[l]:
                Hl = colsk(Hl, j, rmat_adj(c1, s1), lo=wlo, hi=j + 2)
                c1, s1, r = givens_real(getel(Hl, j, j), getel(Hl, j + 1, j))
                Hl = setel(Hl, j, j, r)
                Hl = setel(Hl, j + 1, j, zero)
                Hl = rowsk(Hl, j, lmat(c1, s1), lo=j + 1, hi=whi)
            else:
                Hl = rowsk(Hl, j, lmat(c1, s1), lo=j, hi=whi)
                c1, s1, r = givens_real(getel(Hl, j + 1, j + 1),
                                        -getel(Hl, j + 1, j))
                Hl = setel(Hl, j + 1, j + 1, r)
                Hl = setel(Hl, j + 1, j, zero)
                Hl = colsk(Hl, j, rmat_adj(c1, s1), lo=wlo, hi=j + 1)
            H = H.at[l].set(Hl)
            Z = zup(Z, l, j, rmat_adj(c1, s1))
        H = H.at[0].set(colsk(H[0], j, rmat_adj(c1, s1), lo=wlo))
        return H, Z

    # ------------------------------------------------------------------
    def act_split(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        dvals = lax.dynamic_slice(H, (jnp.int32(0), ilast, ilast),
                                  (p, 1, 1))[:, 0, 0]
        a, b, s = safeprod_signed(dvals, S)
        alr = alr.at[ilast].set(a)
        ali = ali.at[ilast].set(0.0)
        be = be.at[ilast].set(b)
        sc = sc.at[ilast].set(s)
        ilast = ilast - 1
        iiter = jnp.int32(0)
        ziter = jnp.where(ziter != -1, jnp.int32(0), ziter)
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    def act_pos(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        H, Z = pos_core(H, Z, info["jlo"], info["ldef"], info["jdef"], ilast)
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    def act_neg(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        H, Z = neg_core(H, Z, info["jlo"], info["ldef"], info["jdef"], ilast)
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    def act_czshift(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        if aggressive:
            # the reference NotImplements the aggressive controlled-zero-
            # shift combination (src/rgeneralized.jl:245-247); bail with a
            # sentinel the pipeline converts into PSDNotImplemented
            return (H, Z, alr, ali, be, sc, jnp.int32(-5), iiter, ziter,
                    key)
        H, Z, zflag = czshift_core(H, Z, info["jlo"], ilast)
        ziter = jnp.where(zflag, jnp.int32(1), jnp.int32(0))
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    # --- trailing 2x2 block attack (reference :661-790) ------------------
    def act_attack(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        j = ilast - 1
        W = jnp.stack([lax.dynamic_slice(H[l], (j, j), (2, 2))
                       for l in range(p)])
        # attack ordering: Hessenberg block last
        B = jnp.stack([W[(t + 1) % p] for t in range(p)])
        S2 = tuple(S[(t + 1) % p] for t in range(p))
        B, done2 = rp2x2ssr(B, S2)

        def real_pair(HZ):
            H, Z = HZ
            # perfect-shift cascade (reference :695-709)
            one = jnp.ones((), dt)
            c1, s1 = one, one
            for l in range(p - 1, 0, -1):
                r = B[l - 1][1, 1]
                hjj = getel(H[l], j, j)
                if S[l]:
                    c1, s1, _ = givens_real(c1 * hjj, s1 * r)
                else:
                    c1, s1, _ = givens_real(c1 * r, s1 * hjj)
            r = B[p - 1][1, 1]
            c1, s1, _ = givens_real(
                c1 * getel(H[0], j, j) - r * s1, c1 * getel(H[0], j + 1, j))
            wlo = None if want_t else info["jlo"]
            whi = None if want_t else ilast + 1
            return chain510(H, Z, j, c1, s1, wlo=wlo, whi=whi)

        def complex_pair(HZ):
            return HZ

        H, Z = lax.cond(done2, real_pair, complex_pair, (H, Z))

        # complex-pair bookkeeping (only when not done2)
        w1r, w1i, w2r, w2i, s1c, s2c, bflag = eig2x2_product(W, S)
        # standardize: alpha[j] has +|imag|, alpha[j+1] the conjugate
        wi_abs = jnp.abs(w1i)
        upd = ~done2
        alr = jnp.where(upd, alr.at[j].set(w1r).at[j + 1].set(w1r), alr)
        ali = jnp.where(upd, ali.at[j].set(wi_abs).at[j + 1].set(-wi_abs), ali)
        be = jnp.where(upd, be.at[j].set(bflag).at[j + 1].set(bflag), be)
        sc = jnp.where(upd, sc.at[j].set(s1c).at[j + 1].set(s2c), sc)
        ilast = jnp.where(upd, ilast - 2, ilast)
        iiter = jnp.where(upd, jnp.int32(0), iiter)
        ziter = jnp.where(upd & (ziter != -1), jnp.int32(0), ziter)
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    # --- double-implicit-shift sweep (reference :888-1054) ---------------
    def act_sweep(st, info):
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st
        ifirst = info["jlo"]
        iiter = iiter + 1
        ziter = ziter + 1
        c1, s1, c2, s2, key = _opening_rotations(H, S, ifirst, ilast, key,
                                                 iiter)
        # want_t=False: row updates limited to columns <= ilast, column
        # updates to rows >= jlo (reference ifirstm:ilastm when !wantT)
        rhi = None if want_t else ilast + 1
        clo = None if want_t else ifirst

        # opening (reference :890-943); j = ifirst
        j = ifirst
        H0 = colsk(H[0], j + 1, rmat_adj(c2, s2), lo=clo, hi=ilast + 1)
        H0 = colsk(H0, j, rmat_adj(c1, s1), lo=clo, hi=ilast + 1)
        H = H.at[0].set(H0)
        Z = zup(Z, 1 % p, j + 1, rmat_adj(c2, s2))
        Z = zup(Z, 1 % p, j, rmat_adj(c1, s1))
        for l in range(1, p):
            Hl = H[l]
            if S[l]:
                Hl = rowsk(Hl, j + 1, lmat(c2, s2), lo=j, hi=rhi)
                c2, s2, r = givens_real(getel(Hl, j + 2, j + 2),
                                        -getel(Hl, j + 2, j + 1))
                Hl = setel(Hl, j + 2, j + 2, r)
                Hl = setel(Hl, j + 2, j + 1, zero)
                Hl = colsk(Hl, j + 1, rmat_adj(c2, s2), lo=clo, hi=j + 2)
                Hl = rowsk(Hl, j, lmat(c1, s1), lo=j, hi=rhi)
                c1, s1, r = givens_real(getel(Hl, j + 1, j + 1),
                                        -getel(Hl, j + 1, j))
                Hl = setel(Hl, j + 1, j + 1, r)
                Hl = setel(Hl, j + 1, j, zero)
                Hl = colsk(Hl, j, rmat_adj(c1, s1), lo=clo, hi=j + 1)
            else:
                Hl = colsk(Hl, j + 1, rmat_adj(c2, s2), lo=clo, hi=j + 3)
                c2, s2, r = givens_real(getel(Hl, j + 1, j + 1),
                                        getel(Hl, j + 2, j + 1))
                Hl = setel(Hl, j + 1, j + 1, r)
                Hl = setel(Hl, j + 2, j + 1, zero)
                Hl = rowsk(Hl, j + 1, lmat(c2, s2), lo=j + 2, hi=rhi)
                Hl = colsk(Hl, j, rmat_adj(c1, s1), lo=clo, hi=j + 2)
                c1, s1, r = givens_real(getel(Hl, j, j), getel(Hl, j + 1, j))
                Hl = setel(Hl, j, j, r)
                Hl = setel(Hl, j + 1, j, zero)
                Hl = rowsk(Hl, j, lmat(c1, s1), lo=j + 1, hi=rhi)
            H = H.at[l].set(Hl)
            ln = (l + 1) % p
            Z = zup(Z, ln, j + 1, rmat_adj(c2, s2))
            Z = zup(Z, ln, j, rmat_adj(c1, s1))
        H = H.at[0].set(rowsk(H[0], j + 1, lmat(c2, s2), lo=j, hi=rhi))
        H = H.at[0].set(rowsk(H[0], j, lmat(c1, s1), lo=j, hi=rhi))

        # chase (reference :953-1014); j1 in [ifirst+1, ilast-2]
        def chase_step(j1, carry):
            H, Z = carry
            act = (j1 >= ifirst + 1) & (j1 <= ilast - 2)

            def run(HZ):
                H, Z = HZ
                j = j1
                col3 = getcol(H[0], j, j - 1, 3)
                c2, s2, r2 = givens_real(col3[1], col3[2])
                c1, s1, r1 = givens_real(col3[0], r2)
                H0 = setcol(H[0], j, j - 1, jnp.stack([r1, zero, zero]))
                H0 = rowsk(H0, j + 1, lmat(c2, s2), lo=j, hi=rhi)
                H0 = rowsk(H0, j, lmat(c1, s1), lo=j, hi=rhi)
                H = H.at[0].set(H0)
                Z = zup(Z, 0, j + 1, rmat_adj(c2, s2))
                Z = zup(Z, 0, j, rmat_adj(c1, s1))
                for l in range(p - 1, 0, -1):
                    Hl = H[l]
                    if S[l]:
                        Hl = colsk(Hl, j + 1, rmat_adj(c2, s2), lo=clo,
                                   hi=j + 3)
                        fg = getcol(Hl, j + 1, j + 1, 2)
                        c2, s2, r = givens_real(fg[0], fg[1])
                        Hl = setcol(Hl, j + 1, j + 1, jnp.stack([r, zero]))
                        Hl = rowsk(Hl, j + 1, lmat(c2, s2), lo=j + 2, hi=rhi)
                        Hl = colsk(Hl, j, rmat_adj(c1, s1), lo=clo, hi=j + 2)
                        fg = getcol(Hl, j, j, 2)
                        c1, s1, r = givens_real(fg[0], fg[1])
                        Hl = setcol(Hl, j, j, jnp.stack([r, zero]))
                        Hl = rowsk(Hl, j, lmat(c1, s1), lo=j + 1, hi=rhi)
                    else:
                        Hl = rowsk(Hl, j + 1, lmat(c2, s2), lo=j, hi=rhi)
                        fg = getrow(Hl, j + 2, j + 1, 2)
                        c2, s2, r = givens_real(fg[1], -fg[0])
                        Hl = setrow(Hl, j + 2, j + 1, jnp.stack([zero, r]))
                        Hl = colsk(Hl, j + 1, rmat_adj(c2, s2), lo=clo,
                                   hi=j + 2)
                        Hl = rowsk(Hl, j, lmat(c1, s1), lo=j, hi=rhi)
                        fg = getrow(Hl, j + 1, j, 2)
                        c1, s1, r = givens_real(fg[1], -fg[0])
                        Hl = setrow(Hl, j + 1, j, jnp.stack([zero, r]))
                        Hl = colsk(Hl, j, rmat_adj(c1, s1), lo=clo, hi=j + 1)
                    H = H.at[l].set(Hl)
                    Z = zup(Z, l, j + 1, rmat_adj(c2, s2))
                    Z = zup(Z, l, j, rmat_adj(c1, s1))
                lm = jnp.minimum(j + 3, n - 1)
                H = H.at[0].set(colsk(H[0], j + 1, rmat_adj(c2, s2), lo=clo,
                                      hi=lm + 1))
                H = H.at[0].set(colsk(H[0], j, rmat_adj(c1, s1), lo=clo,
                                      hi=lm + 1))
                return H, Z

            return lax.cond(act, run, lambda x: x, (H, Z))

        H, Z = lax.fori_loop(0, n, chase_step, (H, Z))

        # closing rotation at j = ilast-1 (reference :1015-1048)
        j = ilast - 1
        c1, s1, r1 = givens_real(getel(H[0], j, j - 1),
                                 getel(H[0], j + 1, j - 1))
        H0 = setel(H[0], j, j - 1, r1)
        H0 = setel(H0, j + 1, j - 1, zero)
        H = H.at[0].set(H0)
        H, Z = chain510(H, Z, j, c1, s1, wlo=clo, whi=rhi)
        return (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)

    # ------------------------------------------------------------------
    def body(full):
        st, jiter = full
        H, Z, alr, ali, be, sc, ilast, iiter, ziter, key = st

        # Test 1
        d0 = jnp.diagonal(H[0])
        sub0 = jnp.concatenate([jnp.zeros((1,), dt), jnp.diagonal(H[0], -1)])
        if aggressive:
            tol1 = jnp.broadcast_to(agg_tol[0], (n,))
        else:
            tol1 = jnp.abs(jnp.concatenate([jnp.zeros((1,), dt),
                                            d0[:-1]])) + jnp.abs(d0)
            tol1 = jnp.maximum(ulp * tol1, smlnum)
        neg1 = (jnp.abs(sub0) <= tol1) & (iv >= 1) & (iv <= ilast)
        any1 = jnp.any(neg1)
        jstar = jnp.max(jnp.where(neg1, iv, -1))
        jlo = jnp.where(any1, jstar, 0)
        split1 = (ilast == 0) | (any1 & (jstar == ilast))
        H = H.at[0].set(setel(H[0], jstar, jstar - 1, zero, active=any1))

        # Tests 2/3
        dl = jnp.diagonal(H, axis1=1, axis2=2)
        sup = jnp.concatenate(
            [jnp.diagonal(H, 1, 1, 2), jnp.zeros((p, 1), dt)], axis=1)
        supm1 = jnp.concatenate([jnp.zeros((p, 1), dt), sup[:, :-1]], axis=1)
        toltr = jnp.where(
            iv[None, :] == ilast, jnp.abs(supm1),
            jnp.where(iv[None, :] == jlo, jnp.abs(sup),
                      jnp.abs(supm1) + jnp.abs(sup)))
        toltr = jnp.maximum(ulp * toltr, smlnum)
        lv = jnp.arange(p, dtype=jnp.int32)
        negtr = (jnp.abs(dl) <= toltr) & (iv[None, :] >= jlo) & \
                (iv[None, :] <= ilast) & (lv[:, None] >= 1)
        bestj = jnp.max(jnp.where(negtr, iv[None, :], -1), axis=1)
        s_arr = jnp.asarray(S)
        pos_l = jnp.min(jnp.where(s_arr & (bestj >= 0) & (lv >= 1), lv, p + 1))
        neg_l = jnp.min(jnp.where((~s_arr) & (bestj >= 0) & (lv >= 1), lv,
                                  p + 1))
        has_pos = pos_l <= p
        has_neg = neg_l <= p
        ldef = jnp.where(has_pos, pos_l, neg_l).astype(jnp.int32)
        jdef = bestj[jnp.clip(ldef, 0, p - 1)]

        attack = jlo == ilast - 1
        action = jnp.where(
            split1, 0,
            jnp.where(has_pos, 1,
                      jnp.where(has_neg, 2,
                                jnp.where((ziter >= 7) | (ziter < 0), 3,
                                          jnp.where(attack, 5, 4)))))

        info = {"jlo": jlo, "ldef": ldef, "jdef": jdef}
        st = (H, Z, alr, ali, be, sc, ilast, iiter, ziter, key)
        # n == 2: the only window is 2x2, the sweep can never fire (and its
        # trace would build 3x3 slices) -- route slot 4 to the attack too
        sweep_fn = act_attack if n == 2 else act_sweep
        st = lax.switch(action, [act_split, act_pos, act_neg, act_czshift,
                                 sweep_fn, act_attack], st, info)
        return st, jiter + 1

    def cond(full):
        st, jiter = full
        go = (st[6] >= 0) & (jiter < maxit)
        if it_cap is not None:
            go = go & (jiter < it_cap)
        return go

    def body_guarded(full):
        st, jiter = full
        return lax.cond(st[6] >= 0, body, lambda f: (f[0], f[1] + 1), full)

    if resume_state is not None:
        st0, jiter0 = resume_state
    else:
        st0 = (H, Zs, jnp.zeros((n,), dt), jnp.zeros((n,), dt),
               jnp.zeros((n,), dt), jnp.zeros((n,), jnp.int32),
               jnp.int32(n - 1), jnp.int32(0), jnp.int32(ziter0), key0)
        jiter0 = jnp.int32(0)
    fullst, jiter = lax.while_loop(cond, body_guarded, (st0, jiter0))
    (H, Zs, alr, ali, be, sc, ilast, _, _, _) = fullst
    final_state = (fullst, jiter)
    czbail = ilast == -5
    ok = (ilast < 0) & (~czbail)
    done = (ilast < 0) | (jiter >= maxit)

    # scrub: zero subdiagonals under real eigenvalues; triangularize others
    sub = jnp.diagonal(H[0], -1) * jnp.where(ali[:-1] == 0, 0.0, 1.0)
    H0 = H[0] - jnp.diag(jnp.diagonal(H[0], -1), -1) + jnp.diag(sub, -1)
    H = H.at[0].set(H0)
    H = H.at[1:].set(jnp.triu(H[1:]))
    Zout = Zs if want_z else None
    extra = (czbail,) if aggressive else ()
    out = (H, Zout, alr, ali, be, sc, ok) + extra
    if with_info:
        out = out + ({"niter": jiter, "maxit": jnp.int32(maxit)},)
    if return_state:
        out = out + (final_state, done)
    return out


def pqz_real_gen_core_chunked(
    H, S, Z=None, want_z=True, want_t=True, maxitfac=120, seed=1234,
    aggressive=False, chunk_iters=None, cfg=None,
):
    """Host-chunked real generalized QZ with aggressive early deflation.

    Runs the while_loop in resumable it_cap segments with the state left
    on-device between calls; every chunk reuses the ONE resume trace of
    the core.  Same returns as
    :func:`pqz_real_gen_core` (without with_info).  Between chunks the
    host runs aggressive early deflation (ops/aed.py real-generalized
    variant, ``cfg.aed``).
    """
    from ..config import default_config
    if cfg is None:
        cfg = default_config
    p, n, _ = H.shape
    dt = H.dtype
    if n == 1:
        return pqz_real_gen_core(H, S, Z=Z, want_z=want_z, want_t=want_t,
                                 maxitfac=maxitfac, seed=seed,
                                 aggressive=aggressive)
    maxit = maxitfac * n
    if chunk_iters is None:
        # a segment of roughly ten seconds at a modeled per-iteration cost
        per_iter = 2.0 * p * n * max(n * 1e-8, 1.2e-5)
        chunk_iters = max(16, int(10.0 / max(per_iter, 1e-9)))
    fi = jnp.finfo(dt)
    ziter0 = -1 if p >= math.log2(fi.tiny) / math.log2(fi.eps) else 0

    @jax.jit
    def _init(H, Z):
        if want_z:
            Zs = jnp.broadcast_to(jnp.eye(n, dtype=dt),
                                  (p, n, n)).astype(dt) if Z is None else Z
        else:
            Zs = jnp.zeros((p, 1, 1), dt)
        st0 = (H, Zs, jnp.zeros((n,), dt), jnp.zeros((n,), dt),
               jnp.zeros((n,), dt), jnp.zeros((n,), jnp.int32),
               jnp.int32(n - 1), jnp.int32(0), jnp.int32(ziter0),
               jax.random.PRNGKey(seed))
        return (st0, jnp.int32(0))

    # ---- aggressive early deflation plumbing (ops/aed.py, rg variant) ---
    import numpy as _np
    aed_w = cfg.aed_window if cfg.aed_window else min(48, max(16, n // 10))
    aed_itv = cfg.aed_interval if cfg.aed_interval else max(24, n // 6)
    aed_on = bool(cfg.aed) and aed_w >= 4 and n >= aed_w + 4 \
        and (n >= cfg.aed_min_n or cfg.aed_window > 0)
    # max-norm spike scale: zeroing a spike entry perturbs H0 by exactly
    # that entry, so the tolerance is ulp * sqrt(n) * max|H0|
    ulp_eff = float(fi.eps)
    if aed_on:
        from .aed import aed_analyze_rg, aed_apply_rg
        h0 = _np.asarray(H[0], _np.float64)
        aed_tol = ulp_eff * float(n) ** 0.5 * float(_np.abs(h0).max())
        seg = min(chunk_iters, aed_itv)
        misses = 0
    else:
        seg = chunk_iters

    # ---- host-tail finish plumbing (cfg.host_tail) ----------------------
    if cfg.host_tail >= 0:
        from .. import native as _native
        if cfg.host_tail > 0:
            tail_n = min(cfg.host_tail, n)
        else:
            tail_n = min(64, n // 8) if _native.available() else 0
    else:
        tail_n = 0
    if tail_n >= 2:
        from .aed import aed_analyze_rg as _tail_an_rg
        from .aed import aed_apply_rg as _tail_ap_rg
        h0t = _np.asarray(H[0], _np.float64)
        tail_tol = ulp_eff * float(n) ** 0.5 * float(_np.abs(h0t).max())

    def _try_tail(full):
        """Finish the leading window [0, ilast] on the host (beta = 0:
        everything deflates through one native rg window pQZ).  The
        window is embedded at the fixed (p, tail_n) shape so every tail
        reuses one compiled apply."""
        st, jiter = full
        (Hs, Zs, alre, alim, be, sc, ilast, iiter, ziter, key) = st
        m = int(ilast) + 1
        wfix = tail_n
        from ..config import verbosity
        Hbig = _np.asarray(Hs[:, :wfix, :wfix], _np.float64)
        try:
            res = _tail_an_rg(Hbig[:, :m, :m], S, 0.0, tail_tol)
        except Exception as e:  # pragma: no cover - defensive host path
            if verbosity("main") >= 1:
                print(f"[pqz_rg tail] analysis failed ({e!r}); skipping")
            res = None
        if res is None or res[0] != m:
            return full, False
        d, Wf, Zt, arw, aiw, bew, scw, _sph = res
        Vp = _np.broadcast_to(_np.eye(wfix), (p, wfix, wfix)).copy()
        Wp = Hbig.copy()
        for l in range(p):
            ln = (l + 1) % p
            Vp[l][:m, :m] = Zt[l]
            Wp[l][:m, :m] = Wf[l]
            # rows [0, m) of the right-block columns, transformed by the
            # factor's LEFT window transform (signature sides as in
            # aed_apply_rg)
            Vleft = Zt[l] if S[l] else Zt[ln]
            Wp[l][:m, m:] = Vleft.T @ Hbig[l][:m, m:]
        Hs, Zs = _tail_ap_rg(Hs, Zs, jnp.asarray(Vp), jnp.asarray(Wp),
                             jnp.zeros((wfix,)), jnp.int32(0), S,
                             want_z=want_z)
        arr = _np.asarray(alre).copy()
        aii = _np.asarray(alim).copy()
        ben = _np.asarray(be).copy()
        scn = _np.asarray(sc).copy()
        arr[:m] = arw[:m]
        aii[:m] = aiw[:m]
        ben[:m] = bew[:m]
        scn[:m] = scw[:m]
        if verbosity("main") >= 1:
            print(f"[pqz_rg tail] host-finished the leading {m}-window")
        ziter_n = jnp.where(jnp.int32(ziter) != -1, jnp.int32(0),
                            jnp.int32(ziter))
        st = (Hs, Zs, jnp.asarray(arr, dt), jnp.asarray(aii, dt),
              jnp.asarray(ben, dt), jnp.asarray(scn, jnp.int32),
              jnp.int32(-1), jnp.int32(0), ziter_n, key)
        return (st, jiter), True

    def _try_aed(full):
        nonlocal misses, seg
        st, jiter = full
        (Hs, Zs, alre, alim, be, sc, ilast, iiter, ziter, key) = st
        i_cur = int(ilast)
        w = aed_w
        if i_cur + 1 < w + 2:
            return full
        s = i_cur - w + 1
        from ..config import verbosity
        Hwin = _np.asarray(Hs[:, s:s + w, s:s + w], _np.float64)
        bcp = float(_np.asarray(Hs[0, s, s - 1])) if s >= 1 else 0.0
        try:
            res = aed_analyze_rg(Hwin, S, bcp, aed_tol,
                                 max_moves=None if cfg.aed_max_moves < 0 else cfg.aed_max_moves)
        except Exception as e:  # pragma: no cover - defensive host path
            if verbosity("main") >= 1:
                print(f"[pqz_rg aed] analysis failed ({e!r}); skipping")
            res = None
        if res is None:
            misses += 1
            if misses >= 2:
                seg = min(seg * 2, chunk_iters)
            return full
        misses = 0
        seg = min(chunk_iters, aed_itv)
        d, Wf, Zt, arw, aiw, bew, scw, sph = res
        u = w - d
        Hs, Zs = aed_apply_rg(Hs, Zs, jnp.asarray(Zt), jnp.asarray(Wf),
                              jnp.asarray(sph), jnp.int32(s), S,
                              want_z=want_z)
        arr = _np.asarray(alre).copy()
        aii = _np.asarray(alim).copy()
        ben = _np.asarray(be).copy()
        scn = _np.asarray(sc).copy()
        arr[s + u:s + w] = arw[u:]
        aii[s + u:s + w] = aiw[u:]
        ben[s + u:s + w] = bew[u:]
        scn[s + u:s + w] = scw[u:]
        if verbosity("main") >= 1:
            print(f"[pqz_rg aed] deflated {d} at ilast={i_cur} "
                  f"(window {w})")
        ziter_n = jnp.where(jnp.int32(ziter) != -1, jnp.int32(0),
                            jnp.int32(ziter))
        st = (Hs, Zs, jnp.asarray(arr, dt), jnp.asarray(aii, dt),
              jnp.asarray(ben, dt), jnp.asarray(scn, jnp.int32),
              jnp.int32(i_cur - d), jnp.int32(0), ziter_n, key)
        return (st, jiter)

    state = _init(H, Z)
    cap = 0
    while True:
        cap = min(cap + seg, maxit)
        out = pqz_real_gen_core(
            H, S, Z=Z, want_z=want_z, want_t=want_t, maxitfac=maxitfac,
            seed=seed, aggressive=aggressive, it_cap=jnp.int32(cap),
            resume_state=state, return_state=True)
        *outs, state, done = out
        if bool(done) or cap >= maxit:
            return tuple(outs)
        if tail_n >= 2 and 2 <= int(state[0][6]) + 1 <= tail_n:
            state, finished = _try_tail(state)
            if finished:
                # one more (cheap) core call packages outs through the
                # single resume trace
                continue
        if aed_on:
            state = _try_aed(state)


def pschur_real_gen_pipeline(A, S, orient, want_t=True, want_z=True,
                             maxitfac=120, aggressive=False):
    """Full real GPSD: reduction + iteration + packaging.

    aggressive: use fixed per-factor deflation thresholds
    max(safmin, ||H[l]||_1 * ulp) instead of the adaptive neighbor-based
    ones (reference src/rgeneralized.jl:7,54).  Like the reference, the
    combination with the controlled zero shift raises PSDNotImplemented
    (:245-247)."""
    from .hessenberg import phessenberg_core, phessenberg_signed_core
    from .pqr_real import pqr_real_core
    p = A.shape[0]
    if orient == "L":
        A = A[::-1]
        S = tuple(reversed(S))
    if not S[0]:
        raise ValueError("the leftmost signature entry must be +1 (True)")
    if aggressive and p == 1:
        from ..types import PSDNotImplemented
        raise PSDNotImplemented("aggressive deflation with p == 1")
    if p == 1 or all(S):
        H, Q = phessenberg_core(A, want_q=want_z)
        if p == 1:
            T, Z, wr, wi, ok = pqr_real_core(H, Z=Q, want_z=want_z,
                                             want_t=want_t)
            if not bool(ok):
                raise ConvergenceFailure(-1)
            mag = jnp.hypot(wr, wi)
            _, e = jnp.frexp(jnp.where(mag == 0, 1.0, mag))
            k = jnp.where(mag == 0, 0, e - 1).astype(jnp.int32)
            alpha = lax.complex(wr, wi) * jnp.exp2(-k.astype(wr.dtype))
            P = GeneralizedPeriodicSchur(
                S=S, schurindex=0, Ts=T, Zs=Z,
                alpha=alpha, beta=jnp.ones((A.shape[1],), wr.dtype),
                alphascale=k, orientation="R")
            return rev_alias(P) if orient == "L" else P
    else:
        H, Q = phessenberg_signed_core(A, S, want_q=want_z)
    from ..config import verbosity
    czbail = False
    if verbosity("main") >= 1:
        out = pqz_real_gen_core(H, S, Z=Q, want_z=want_z, want_t=want_t,
                                maxitfac=maxitfac,
                                with_info=True, aggressive=aggressive)
        info = out[-1]
        out = out[:-1]
        print(f"[pschur real gen] p={p} n={A.shape[-1]}: "
              f"{int(info['niter'])} iterations "
              f"(budget {int(info['maxit'])}), converged={bool(out[6])}")
    else:
        out = pqz_real_gen_core(H, S, Z=Q, want_z=want_z, want_t=want_t,
                                maxitfac=maxitfac,
                                aggressive=aggressive)
    if aggressive:
        T, Z, alr, ali, be, sc, ok, czbail = out
    else:
        T, Z, alr, ali, be, sc, ok = out
    if bool(czbail):
        from ..types import PSDNotImplemented
        raise PSDNotImplemented(
            "controlled zero shift with aggressive deflation "
            "(reference src/rgeneralized.jl:245-247)")
    if not bool(ok):
        raise ConvergenceFailure(-1)
    P = GeneralizedPeriodicSchur(
        S=S, schurindex=0, Ts=T, Zs=Z, alpha=lax.complex(alr, ali), beta=be,
        alphascale=sc, orientation="R")
    return rev_alias(P) if orient == "L" else P
