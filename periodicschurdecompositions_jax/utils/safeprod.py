"""Overflow-safe signed products in (mantissa, exponent) form.

Behavioral contract from the reference's `_safeprod`
(src/generalized.jl:933-976 and src/utils.jl:90-120): represent

    prod_l x[l]^(±1)  as  alpha / beta * 2^scale

with ``|alpha| ∈ [1,2) ∪ {0}``, ``beta ∈ {0,1}`` (``beta = 0`` encodes an
infinite eigenvalue arising from a zero diagonal in an inverted factor;
``alpha = beta = 0`` encodes 0/0 from a zero in a direct factor meeting a
zero in an inverted one).

The reference renormalizes with repeated multiply/divide-by-2 loops; here the
renormalization is an exact power-of-two rescale via frexp/ldexp, applied
after every factor exactly like the reference so intermediate products never
over/underflow even for p in the thousands.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp


def pow2_scale(x, k):
    """Exact ``x * 2**k`` by arithmetic alone (an ldexp without bitcasts).

    This variant multiplies by exact power-of-two constants, one binary
    digit of ``|k|`` at a time in DESCENDING order, so every intermediate
    lies between ``|x|`` and ``|x * 2**k|`` — no transient
    overflow/underflow when both endpoints are representable.  Valid for ``|k| <= 2047``.

    ``k``: int32 array (broadcast-compatible with ``x``).  Complex ``x``
    scales re/im parts independently (still exact).
    """
    if jnp.issubdtype(jnp.asarray(x).dtype, jnp.complexfloating):
        return pow2_scale(x.real, k) + 1j * pow2_scale(x.imag, k)
    x = jnp.asarray(x)
    dt = x.dtype
    kk = jnp.asarray(k, jnp.int32)
    neg = kk < 0
    ka = jnp.where(neg, -kk, kk)
    out = x
    for j in range(10, -1, -1):
        bv = 1 << j
        # 2^1024 overflows f64: apply the 1024-bit as 2^512 twice.
        reps, base = (2, 512) if bv > 512 else (1, bv)
        cpos = jnp.asarray(float(2.0 ** base), dt)
        cneg = jnp.asarray(float(2.0 ** -base), dt)
        c = jnp.where(neg, cneg, cpos)
        bit = ((ka >> j) & 1) == 1
        for _ in range(reps):
            out = jnp.where(bit, out * c, out)
    return out


def frexp_exp(mag):
    """frexp-style exponent of ``mag > 0``: e with ``mag = m * 2^e``,
    ``m ∈ [0.5, 1)``, by arithmetic alone (no bitcasts).

    ``floor(log2)`` candidate plus one exact-rescale correction step (the
    log2 rounding error is far below 1, so the candidate is off by at most
    one).  Non-finite / zero inputs return e = 0.

    Subnormal inputs: XLA flushes subnormals to zero in arithmetic
    (DAZ/FTZ), so a subnormal ``mag`` compares ``== 0``
    here and returns e = 0 — consistent with how every other arithmetic op
    in the library sees it (the renorm-every-factor design keeps live
    quantities out of that range; the pre-scale below only helps on
    backends whose log2 flushes but whose mul does not).
    """
    mag = jnp.asarray(mag)
    fi = jnp.finfo(mag.dtype)
    # log2 flushes subnormals to -inf: pre-scale tiny inputs into the
    # normal range by an exact power of two and subtract it back.
    lift_k = int(fi.nmant) + 3
    tiny = mag < jnp.asarray(fi.tiny)
    lift = jnp.asarray(float(2.0 ** lift_k), mag.dtype)
    mags = jnp.where(tiny, mag * lift, mag)
    ef = jnp.floor(jnp.log2(jnp.where(mag > 0, mags, jnp.ones_like(mag)))) + 1.0
    ef = jnp.where(jnp.isfinite(ef), ef, jnp.zeros_like(ef))
    e0 = jnp.clip(ef, -1990.0, 1990.0).astype(jnp.int32) \
        - jnp.where(tiny, jnp.int32(lift_k), jnp.int32(0))
    m = pow2_scale(mag, -e0)
    e = e0 + jnp.where(m >= 1.0, jnp.int32(1), jnp.int32(0)) \
           - jnp.where(m < 0.5, jnp.int32(1), jnp.int32(0))
    ok = jnp.isfinite(mag) & (mag > 0)
    return jnp.where(ok, e, jnp.zeros_like(e))


def _renorm(alpha, scale):
    """Rescale so |alpha| ∈ [1,2) (alpha == 0 resets scale, like the ref)."""
    mag = jnp.abs(alpha)
    e = frexp_exp(jnp.where(mag == 0, jnp.ones_like(mag), mag))
    # |alpha| = m * 2^e with m in [0.5, 1)  ->  multiply by 2^(1-e)
    k = 1 - e
    alpha2 = pow2_scale(alpha, k)
    scale2 = scale + e - 1
    iszero = mag == 0
    alpha_out = jnp.where(iszero, jnp.zeros_like(alpha), alpha2)
    scale_out = jnp.where(iszero, jnp.zeros_like(scale), scale2)
    return alpha_out, scale_out


def safeprod_signed(x, S: Sequence[bool]) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Scaled product of ``x[l] ** (+1 if S[l] else -1)``.

    ``x``: (p,) array (real or complex); ``S``: static sequence of bool.
    Returns (alpha, beta, scale[int32]).  Vectorize with vmap for batches.
    """
    p = x.shape[0]
    assert len(S) == p
    dt = x.dtype
    rdt = jnp.finfo(dt).dtype
    alpha = jnp.ones((), dt)
    beta = jnp.ones((), rdt)
    scale = jnp.zeros((), jnp.int32)
    for l in range(p):
        xl = x[l]
        if S[l]:
            alpha = alpha * xl
        else:
            iszero = xl == 0
            beta = jnp.where(iszero, jnp.zeros_like(beta), beta)
            alpha = jnp.where(iszero, alpha, alpha / jnp.where(iszero, jnp.ones_like(xl), xl))
        alpha, scale = _renorm(alpha, scale)
    return alpha, beta, scale


def safeprod(x) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Scaled product of all entries (all-positive signature)."""
    return safeprod_signed(x, (True,) * int(x.shape[0]))


def safeprod_signed_split(xre, xim, S) -> Tuple[jnp.ndarray, jnp.ndarray,
                                                jnp.ndarray, jnp.ndarray]:
    """Split-complex ``safeprod_signed``: complex input as (re, im) pairs.

    The split QZ core (ops/pqz_complex_split.py) accumulates its
    eigenvalue products through this variant.  Returns (alpha_re, alpha_im, beta, scale).
    """
    p = xre.shape[0]
    assert len(S) == p
    rdt = xre.dtype
    ar = jnp.ones((), rdt)
    ai = jnp.zeros((), rdt)
    beta = jnp.ones((), rdt)
    scale = jnp.zeros((), jnp.int32)
    for l in range(p):
        xr, xi = xre[l], xim[l]
        if S[l]:
            ar, ai = ar * xr - ai * xi, ar * xi + ai * xr
        else:
            iszero = (xr == 0) & (xi == 0)
            beta = jnp.where(iszero, jnp.zeros_like(beta), beta)
            d = xr * xr + xi * xi
            ds = jnp.where(iszero, jnp.ones_like(d), d)
            nr = (ar * xr + ai * xi) / ds
            ni = (ai * xr - ar * xi) / ds
            ar = jnp.where(iszero, ar, nr)
            ai = jnp.where(iszero, ai, ni)
        # renorm |alpha| into [1, 2)
        mag = jnp.hypot(ar, ai)
        e = frexp_exp(jnp.where(mag == 0, jnp.ones_like(mag), mag))
        k = 1 - e
        ar2, ai2 = pow2_scale(ar, k), pow2_scale(ai, k)
        scale2 = scale + e - 1
        iszero = mag == 0
        ar = jnp.where(iszero, jnp.zeros_like(ar), ar2)
        ai = jnp.where(iszero, jnp.zeros_like(ai), ai2)
        scale = jnp.where(iszero, jnp.zeros_like(scale), scale2)
    return ar, ai, beta, scale
