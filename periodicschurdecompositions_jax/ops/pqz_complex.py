"""Complex generalized periodic Schur core: single-shift periodic QZ.

Behavioral contract from the reference's complex `pschur!` (src/generalized.jl
:166-931, an MB03BZ-style iteration).  Given ``H[0]`` upper Hessenberg and
``H[1..p-1]`` upper triangular (complex), and a static signature ``S`` with
``S[0] = True``, compute unitary ``Z[l]`` such that the cycle becomes upper
triangular with the product's eigenvalues in decomposed
``alpha/beta * 2^scale`` form.

Re-design (SURVEY.md §7): ONE ``lax.while_loop`` runs the whole
iteration; the active window ``[jlo, ilast]`` is integer state; each
iteration selects one action via ``lax.switch``:

  0 SPLIT        deflate a 1x1 block at ``ilast`` (scaled eigenvalue product)
  1 DEFLATE_POS  a zero diagonal in a non-inverted triangular factor
  2 DEFLATE_NEG  a zero diagonal in an inverted factor (zero chasing)
  3 CZSHIFT      controlled zero shift (triangularize/re-propagate the cycle)
  4 SWEEP        one single-shift QZ sweep over the window

Rotation chains run as masked ``fori_loop`` sweeps over statically shaped
2-row/2-column slab updates; the cycle dimension p is unrolled (static).
Deviations from the reference (documented):

* deflation tests are mutually exclusive with priority 1>2>3>4 (the Fortran
  GOTO semantics); the Julia translation lets a later test clobber an
  earlier match in rare multi-match iterations.
* the rare ``tol == 0`` fallback to a block 1-norm in the negligibility
  tests is replaced by the ``smlnum`` floor alone (strictly stricter).
* row/column update ranges always span the full matrix (the reference does
  the same when ``wantT=true``; we always keep T).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.safeprod import safeprod_signed
from .rotations import (colsk, getcol, getel, getrow, givens_complex, lmat,
                        rmat_adj, rowsk, setcol, setel, setrow)


def _eye_stack(p, n, dt):
    return jnp.broadcast_to(jnp.eye(n, dtype=dt), (p, n, n)).astype(dt)


@partial(jax.jit, static_argnames=("S", "want_z", "maxitfac", "with_info",
                                   "want_t"))
def pqz_complex_core(
    H: jax.Array,
    S: Tuple[bool, ...],
    Z: Optional[jax.Array] = None,
    want_z: bool = True,
    maxitfac: int = 30,
    seed: int = 1234,
    with_info: bool = False,
    want_t: bool = True,
):
    """Run the complex periodic QZ iteration.

    Args:
      H: (p, n, n) complex stack; H[0] upper Hessenberg, H[1:] upper
         triangular.
      S: static tuple of bools, S[0] must be True.
      Z: optional (p, n, n) initial unitary stack (accumulated into).
      want_z: accumulate Schur vectors.
      maxitfac: iteration budget factor (maxit = maxitfac * n).
      seed: PRNG seed for exceptional shifts.
      want_t: when False the sweep restricts row/column updates to the
        active window [jlo, ilast] (the reference's ifirstm:ilastm device,
        src/generalized.jl:202-227,756-775): eigenvalues are exact but the
        returned T is only valid on the block diagonal.  Out-of-window
        regions are element-wise decoupled from the window, so skipping
        their updates cannot perturb in-window values.

    Returns:
      (T, Z, alpha, beta, alphascale, ok): T triangularized stack, Z updated
      stack (or dummy if want_z=False), eigenvalue parts, and a success flag
      (False if the iteration budget was exhausted).  ``with_info=True``
      appends a counter dict (reference prints tallies at verbosity > 0).
    """
    p, n, _ = H.shape
    assert S[0], "signature entry S[0] must be True"
    dt = H.dtype
    rdt = jnp.finfo(dt).dtype
    fi = jnp.finfo(rdt)
    ulp = float(fi.eps)
    unfl = float(fi.tiny)
    smlnum = unfl * (n / ulp)
    safmin = unfl
    maxit = maxitfac * n
    ziter0 = -1 if p >= math.log2(fi.tiny) / math.log2(ulp) else 0

    if want_z:
        Zs = _eye_stack(p, n, dt) if Z is None else Z
    else:
        Zs = jnp.zeros((p, 1, 1), dt)

    if n == 1:
        a, b, s = safeprod_signed(H[:, 0, 0], S)
        return (H, Zs if want_z else None, a[None], b[None], s[None],
                jnp.asarray(True))

    alpha0 = jnp.zeros((n,), dt)
    beta0 = jnp.zeros((n,), rdt)
    scal0 = jnp.zeros((n,), jnp.int32)
    key0 = jax.random.PRNGKey(seed)

    iv = jnp.arange(n, dtype=jnp.int32)

    def zup(Z, l, k, M, active=None):
        """Apply a 2x2 right-update to Z[l] columns (k, k+1) (static l)."""
        if not want_z:
            return Z
        return Z.at[l].set(colsk(Z[l], k, M, active=active))

    # ------------------------------------------------------------------
    # action 0: SPLIT a 1x1 at ilast
    def act_split(st, info):
        H, Z, al, be, sc, ilast, iiter, ziter, key = st
        dvals = lax.dynamic_slice(H, (jnp.int32(0), ilast, ilast), (p, 1, 1))[:, 0, 0]
        a, b, s = safeprod_signed(dvals, S)
        al = al.at[ilast].set(a)
        be = be.at[ilast].set(b)
        sc = sc.at[ilast].set(s)
        ilast = ilast - 1
        iiter = jnp.int32(0)
        ziter = jnp.where(ziter != -1, jnp.int32(0), ziter)
        return (H, Z, al, be, sc, ilast, iiter, ziter, key)

    # ------------------------------------------------------------------
    # action 3: controlled zero shift (shared core)
    def act_czshift(st, info):
        H, Z, al, be, sc, ilast, iiter, ziter, key = st
        H, Z, zflag = czshift_core(H, Z, info["jlo"], ilast)
        ziter = jnp.where(zflag, jnp.int32(1), jnp.int32(0))
        return (H, Z, al, be, sc, ilast, iiter, ziter, key)

    # ------------------------------------------------------------------
    # action 4: single-shift QZ sweep (reference src/generalized.jl:770-852)
    def act_sweep(st, info):
        H, Z, al, be, sc, ilast, iiter, ziter, key = st
        jlo = info["jlo"]
        ifirst = jlo
        iiter = iiter + 1
        ziter = ziter + 1

        # --- shift: normal (product Wilkinson-ish via iterated Givens) ---
        c = jnp.asarray(1.0, rdt)
        s = jnp.asarray(0.0, dt)
        c, s, _ = givens_complex(jnp.asarray(1.0, dt), jnp.asarray(1.0, dt))
        for l in range(p - 1, 0, -1):
            hf = getel(H[l], ifirst, ifirst)
            hl = getel(H[l], ilast, ilast)
            if S[l]:
                c, s, _ = givens_complex(hf * c, hl * jnp.conj(s))
            else:
                c, s, _ = givens_complex(hl * c, -hf * jnp.conj(s))
                s = -s
        h0f = getel(H[0], ifirst, ifirst)
        h0l = getel(H[0], ilast, ilast)
        h0sub = getel(H[0], ifirst + 1, ifirst)
        c, s, _ = givens_complex(h0f * c - h0l * jnp.conj(s), h0sub * c)

        # --- exceptional shift every 10 iterations: random rotation ---
        key, sub = jax.random.split(key)
        fg = jax.random.normal(sub, (4,), rdt)
        ce, se, _ = givens_complex(fg[0] + 1j * fg[1], fg[2] + 1j * fg[3])
        exc = (iiter % 10) == 0
        c = jnp.where(exc, ce, c)
        s = jnp.where(exc, se, s)

        # --- the sweep ---
        # want_t=False: restrict to the active window (ifirstm:ilastm of
        # the reference when !wantT) — row updates to columns <= ilast,
        # column updates to rows >= jlo
        rhi = None if want_t else ilast + 1
        clo = None if want_t else jlo

        def sweep_step(k, carry):
            H, Z, c, s = carry
            act = (k >= ifirst) & (k <= ilast - 1)
            regen = act & (k > ifirst)
            fg = getcol(H[0], k, k - 1, 2)
            cn, sn, r = givens_complex(fg[0], fg[1])
            H = H.at[0].set(setcol(H[0], k, k - 1,
                                   jnp.stack([r, jnp.zeros((), dt)]),
                                   active=regen))
            c = jnp.where(regen, cn, c)
            s = jnp.where(regen, sn, s)
            H = H.at[0].set(rowsk(H[0], k, lmat(c, s), lo=k, hi=rhi,
                                  active=act))
            Z = zup(Z, 0, k, rmat_adj(c, s), active=act)
            for l in range(p - 1, 0, -1):
                if S[l]:
                    Hl = colsk(H[l], k, rmat_adj(c, s), lo=clo, hi=k + 2,
                               active=act)
                    fg = getcol(Hl, k, k, 2)
                    cn, sn, r = givens_complex(fg[0], fg[1])
                    Hl = setcol(Hl, k, k, jnp.stack([r, jnp.zeros((), dt)]),
                                active=act)
                    Hl = rowsk(Hl, k, lmat(cn, sn), lo=k + 1, hi=rhi,
                               active=act)
                else:
                    Hl = rowsk(H[l], k, lmat(c, s), lo=k, hi=rhi, active=act)
                    fg = getrow(Hl, k + 1, k, 2)
                    cn, sn, r = givens_complex(fg[1], fg[0])
                    Hl = setrow(Hl, k + 1, k,
                                jnp.stack([jnp.zeros((), dt), r]), active=act)
                    Hl = colsk(Hl, k, lmat(cn, sn), lo=clo, hi=k + 1,
                               active=act)
                    sn = -sn
                H = H.at[l].set(Hl)
                c = jnp.where(act, cn, c)
                s = jnp.where(act, sn, s)
                Z = zup(Z, l, k, rmat_adj(c, s), active=act)
            H = H.at[0].set(
                colsk(H[0], k, rmat_adj(c, s), lo=clo,
                      hi=jnp.minimum(k + 3, n), active=act))
            return H, Z, c, s

        H, Z, c, s = lax.fori_loop(0, n - 1, sweep_step, (H, Z, c, s))
        return (H, Z, al, be, sc, ilast, iiter, ziter, key)

    # ------------------------------------------------------------------
    # actions 1/2: singular triangular factor deflations
    from .pqz_deflate import make_deflate_cores
    pos_core, neg_core, czshift_core = make_deflate_cores(
        p=p, n=n, S=S, dt=dt, rdt=rdt, want_z=want_z, ulp=ulp, smlnum=smlnum)

    def act_pos(st, info):
        H, Z, al, be, sc, ilast, iiter, ziter, key = st
        H, Z = pos_core(H, Z, info["jlo"], info["ldef"], info["jdef"], ilast)
        return (H, Z, al, be, sc, ilast, iiter, ziter, key)

    def act_neg(st, info):
        H, Z, al, be, sc, ilast, iiter, ziter, key = st
        H, Z = neg_core(H, Z, info["jlo"], info["ldef"], info["jdef"], ilast)
        return (H, Z, al, be, sc, ilast, iiter, ziter, key)

    # ------------------------------------------------------------------
    # per-iteration deflation analysis + dispatch
    def body(full):
        st, jiter = full
        H, Z, al, be, sc, ilast, iiter, ziter, key = st

        # Test 1: negligible Hessenberg subdiagonal (bottom-most)
        d0 = jnp.diagonal(H[0])
        sub0 = jnp.concatenate([jnp.zeros((1,), dt), jnp.diagonal(H[0], -1)])
        tol1 = jnp.abs(jnp.concatenate([jnp.zeros((1,), dt), d0[:-1]])) + jnp.abs(d0)
        tol1 = jnp.maximum(ulp * tol1, smlnum)
        neg1 = (jnp.abs(sub0) <= tol1) & (iv >= 1) & (iv <= ilast)
        any1 = jnp.any(neg1)
        jstar = jnp.max(jnp.where(neg1, iv, -1))
        jlo = jnp.where(any1, jstar, 0)
        split1 = (ilast == 0) | (any1 & (jstar == ilast))
        H = H.at[0].set(setel(H[0], jstar, jstar - 1, jnp.zeros((), dt),
                              active=any1))

        # Tests 2/3: negligible diagonal in a triangular factor
        dl = jnp.diagonal(H, axis1=1, axis2=2)                       # (p, n)
        sup = jnp.concatenate(
            [jnp.diagonal(H, 1, 1, 2), jnp.zeros((p, 1), dt)], axis=1)  # H[l][j, j+1]
        supm1 = jnp.concatenate([jnp.zeros((p, 1), dt), sup[:, :-1]], axis=1)
        toltr = jnp.where(
            iv[None, :] == ilast, jnp.abs(supm1),
            jnp.where(iv[None, :] == jlo, jnp.abs(sup),
                      jnp.abs(supm1) + jnp.abs(sup)))
        toltr = jnp.maximum(ulp * toltr, smlnum)
        lv = jnp.arange(p, dtype=jnp.int32)
        negtr = (jnp.abs(dl) <= toltr) & (iv[None, :] >= jlo) & \
                (iv[None, :] <= ilast) & (lv[:, None] >= 1)
        bestj = jnp.max(jnp.where(negtr, iv[None, :], -1), axis=1)    # (p,)
        s_arr = jnp.asarray(S)
        pos_l = jnp.min(jnp.where(s_arr & (bestj >= 0) & (lv >= 1), lv, p + 1))
        neg_l = jnp.min(jnp.where((~s_arr) & (bestj >= 0) & (lv >= 1), lv, p + 1))
        has_pos = pos_l <= p
        has_neg = neg_l <= p
        ldef = jnp.where(has_pos, pos_l, neg_l).astype(jnp.int32)
        jdef = bestj[jnp.clip(ldef, 0, p - 1)]

        action = jnp.where(
            split1, 0,
            jnp.where(has_pos, 1,
                      jnp.where(has_neg, 2,
                                jnp.where((ziter >= 7) | (ziter < 0), 3, 4))))

        info = {"jlo": jlo, "ldef": ldef, "jdef": jdef}
        st = (H, Z, al, be, sc, ilast, iiter, ziter, key)
        st = lax.switch(action, [act_split, act_pos, act_neg, act_czshift,
                                 act_sweep], st, info)
        return st, jiter + 1

    def cond(full):
        st, jiter = full
        ilast = st[5]
        return (ilast >= 0) & (jiter < maxit)

    def body_guarded(full):
        st, jiter = full
        return lax.cond(st[5] >= 0, body, lambda f: (f[0], f[1] + 1), full)

    st0 = (H, Zs, alpha0, beta0, scal0, jnp.int32(n - 1), jnp.int32(0),
           jnp.int32(ziter0), key0)
    (H, Zs, alpha, beta, scal, ilast, _, _, _), jiter = lax.while_loop(
        cond, body_guarded, (st0, jnp.int32(0)))
    ok = ilast < 0

    # ------------------------------------------------------------------
    # postprocess: rescale triangular diagonals to nonnegative reals,
    # pushing phases into Z and the neighbor factor
    # (reference src/generalized.jl:860-908)
    for l in range(p - 1, 0, -1):
        d = jnp.diagonal(H[l])
        absd = jnp.abs(d)
        z = jnp.where(absd > safmin, jnp.conj(d) / jnp.where(absd == 0, 1, absd),
                      jnp.ones((), dt))
        newdiag = jnp.where(absd > safmin, absd.astype(dt), d)
        if S[l]:
            Hl = z[:, None] * H[l]
            sf = z
        else:
            Hl = H[l] * z[None, :]
            sf = jnp.conj(z)
        Hl = Hl - jnp.diag(jnp.diagonal(Hl)) + jnp.diag(newdiag)
        H = H.at[l].set(Hl)
        if want_z:
            Zs = Zs.at[l].set(Zs[l] * jnp.conj(sf)[None, :])
        lm = l - 1
        if S[lm]:
            H = H.at[lm].set(H[lm] * jnp.conj(sf)[None, :])
        else:
            H = H.at[lm].set(sf[:, None] * H[lm])

    Zout = Zs if want_z else None
    if with_info:
        return H, Zout, alpha, beta, scal, ok, {
            "niter": jiter, "maxit": jnp.int32(maxit)}
    return H, Zout, alpha, beta, scal, ok
