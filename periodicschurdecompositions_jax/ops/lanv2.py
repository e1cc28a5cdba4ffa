"""Standardization of a real 2x2 block (LAPACK dlanv2 semantics).

Behavioral contract from the reference's `_gs2x2!` (src/rschur2x2.jl:9-96),
itself a dlanv2 translation: given a real 2x2 [[a,b],[c,d]], compute the
rotation (cs, sn) and transformed entries so that the block is in standard
real Schur form — either c == 0 (two real eigenvalues) or b*c < 0 with
a == d (a complex conjugate pair) — and return both eigenvalues.

Implemented branchlessly (nested where-selects over all branch candidates)
so it is jit/vmap-safe: the deflation stages vmap this over many 2x2 blocks.
All divisions/sqrt in untaken branches are guarded against producing inf/nan
that could poison the selected value.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _sgn(x):
    # Fortran SIGN convention: sign(0) == +1
    return jnp.where(x >= 0, jnp.ones_like(x), -jnp.ones_like(x))


def _csign(mag, s):
    return jnp.where(s >= 0, jnp.abs(mag), -jnp.abs(mag))


def _safe(x):
    return jnp.where(x == 0, jnp.ones_like(x), x)


def _hypot(x, y):
    m = jnp.maximum(jnp.abs(x), jnp.abs(y))
    ms = _safe(m)
    return m * jnp.sqrt((x / ms) ** 2 + (y / ms) ** 2)


def lanv2(a, b, c, d):
    """Standardize [[a,b],[c,d]].

    Returns (a, b, c, d, cs, sn, w1r, w1i, w2r, w2i): (cs, sn) is the Givens
    rotation G = [[cs, sn], [-sn, cs]] with G @ [[a0,b0],[c0,d0]] @ G.T =
    [[a,b],[c,d]]; the eigenvalues are returned as real/imag PAIRS so the
    real pipeline stays complex-free.
    """
    dt = jnp.result_type(a, b, c, d)
    a, b, c, d = (jnp.asarray(x, dt) for x in (a, b, c, d))
    one = jnp.ones((), dt)
    zero = jnp.zeros((), dt)
    eps = jnp.finfo(dt).eps
    small = 4 * eps

    # ---- branch B4 (general case) -------------------------------------
    temp = a - d
    p = 0.5 * temp
    bcmax = jnp.maximum(jnp.abs(b), jnp.abs(c))
    bcmis = jnp.minimum(jnp.abs(b), jnp.abs(c)) * _sgn(b) * _sgn(c)
    scale = jnp.maximum(jnp.abs(p), bcmax)
    scs = _safe(scale)
    z = (p / scs) * p + (bcmax / scs) * bcmis

    # B4a: z >= small -> real eigenvalues
    z4a = p + _csign(jnp.sqrt(scs) * jnp.sqrt(jnp.maximum(z, zero)), p)
    z4as = _safe(z4a)
    a4a = d + z4a
    d4a = d - (bcmax / z4as) * bcmis
    tau4a = _safe(_hypot(c, z4a))
    cs4a = z4a / tau4a
    sn4a = c / tau4a
    b4a = b - c
    c4a = zero

    # B4b: complex or almost-equal real eigenvalues
    sigma = b + c
    tau4b = _safe(_hypot(sigma, temp))
    cs4b = jnp.sqrt(0.5 * (one + jnp.abs(sigma) / tau4b))
    sn4b = -(p / (tau4b * _safe(cs4b))) * _sgn(sigma)
    #   rotate the original block by (cs4b, sn4b)
    aa = a * cs4b + b * sn4b
    bb = -a * sn4b + b * cs4b
    cc = c * cs4b + d * sn4b
    dd = -c * sn4b + d * cs4b
    a_ = aa * cs4b + cc * sn4b
    b_ = bb * cs4b + dd * sn4b
    c_ = -aa * sn4b + cc * cs4b
    d_ = -bb * sn4b + dd * cs4b
    mid = 0.5 * (a_ + d_)
    a_ = mid
    d_ = mid
    #   sub-branch: c_ != 0 and b_ != 0 and sgn(b_) == sgn(c_): real eigvals
    sab = jnp.sqrt(jnp.abs(b_))
    sac = jnp.sqrt(jnp.abs(c_))
    p2 = _csign(sab * sac, c_)
    tau2 = one / _safe(jnp.sqrt(jnp.abs(b_ + c_)))
    cs1 = sab * tau2
    sn1 = sac * tau2
    cond_real = (c_ != 0) & (b_ != 0) & (_sgn(b_) == _sgn(c_))
    a4b = jnp.where(cond_real, mid + p2, a_)
    d4b = jnp.where(cond_real, mid - p2, d_)
    b4b = jnp.where(cond_real, b_ - c_, b_)
    c4b = jnp.where(cond_real, zero, c_)
    csr = cs4b * cs1 - sn4b * sn1
    snr = cs4b * sn1 + sn4b * cs1
    cs4b2 = jnp.where(cond_real, csr, cs4b)
    sn4b2 = jnp.where(cond_real, snr, sn4b)
    #   sub-branch: c_ != 0 and b_ == 0: swap roles
    cond_swap = (c_ != 0) & (b_ == 0)
    b4b = jnp.where(cond_swap, -c_, b4b)
    c4b = jnp.where(cond_swap, zero, c4b)
    cs4bf = jnp.where(cond_swap, -sn4b, cs4b2)
    sn4bf = jnp.where(cond_swap, cs4b, sn4b2)

    use4a = z >= small
    aB4 = jnp.where(use4a, a4a, a4b)
    bB4 = jnp.where(use4a, b4a, b4b)
    cB4 = jnp.where(use4a, c4a, c4b)
    dB4 = jnp.where(use4a, d4a, d4b)
    csB4 = jnp.where(use4a, cs4a, cs4bf)
    snB4 = jnp.where(use4a, sn4a, sn4bf)

    # ---- top-level branch select ---------------------------------------
    is_b1 = c == 0
    is_b2 = (~is_b1) & (b == 0)
    is_b3 = (~is_b1) & (~is_b2) & (temp == 0) & (b * c < 0)

    af = jnp.where(is_b1 | is_b3, a, jnp.where(is_b2, d, aB4))
    bf = jnp.where(is_b1 | is_b3, b, jnp.where(is_b2, -c, bB4))
    cf = jnp.where(is_b1 | is_b3, c, jnp.where(is_b2, zero, cB4))
    df = jnp.where(is_b1 | is_b3, d, jnp.where(is_b2, a, dB4))
    csf = jnp.where(is_b1 | is_b3, one, jnp.where(is_b2, zero, csB4))
    snf = jnp.where(is_b1 | is_b3, zero, jnp.where(is_b2, one, snB4))

    # ---- eigenvalues ----------------------------------------------------
    # returned as (re, im) PAIRS: the real cores stay complex-free
    rti = jnp.sqrt(jnp.abs(bf)) * jnp.sqrt(jnp.abs(cf))
    imagpart = jnp.where(cf == 0, jnp.zeros_like(rti), rti)
    return af, bf, cf, df, csf, snf, af, imagpart, df, -imagpart
