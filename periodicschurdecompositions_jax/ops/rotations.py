"""Givens rotation generation and masked pair (2-row / 2-column) application.

Generation follows LAPACK dlartg/zlartg semantics (the reference relies on
Julia's ``givensAlgorithm``, same family): ``c`` is real, and

    [ c        s ] [ f ]   [ r ]
    [ -conj(s) c ] [ g ] = [ 0 ].

Exact-zero inputs return exact identity data so that structural zeros are
preserved (``g == 0  ->  (1, 0, f)``).

Application is via explicit 2x2 matrices acting on an adjacent index pair
``(i, i+1)`` of rows or columns, with a traced column/row window ``[lo, hi)``
and an ``active`` predicate, so iteration cores can run statically shaped
``fori_loop``/``scan`` sweeps and mask out inactive steps.  All dynamic
starts are clamped so out-of-range *inactive* steps cannot fault.

2x2 matrix builders correspond to the reference's uses of ``lmul!(G, ·)`` /
``rmul!(·, G')`` with ``G = Givens(i, i+1, c, s)`` (reference:
src/generalized.jl:806-852 and every sweep loop).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


# -----------------------------------------------------------------------------
# Generation


def givens_real(f, g):
    """Real Givens: (c, s, r) with ``[c s; -s c] @ [f, g] = [r, 0]``, c >= 0.

    g == 0 -> (1, 0, f) exactly; f == 0 -> (0, sign(g), |g|).
    Safe against overflow/underflow via max-scaling.
    """
    dt = jnp.result_type(f, g)
    f = jnp.asarray(f, dt)
    g = jnp.asarray(g, dt)
    af, ag = jnp.abs(f), jnp.abs(g)
    scale = jnp.maximum(af, ag)
    sc = jnp.where(scale == 0, jnp.asarray(1.0, dt), scale)
    fs, gs = f / sc, g / sc
    d = sc * jnp.sqrt(fs * fs + gs * gs)
    dsafe = jnp.where(d == 0, jnp.asarray(1.0, dt), d)
    r_gen = jnp.where(f >= 0, d, -d)
    c_gen = af / dsafe
    s_gen = g / jnp.where(r_gen == 0, jnp.asarray(1.0, dt), r_gen)
    sgn_g = jnp.where(g >= 0, jnp.asarray(1.0, dt), jnp.asarray(-1.0, dt))
    c = jnp.where(g == 0, jnp.asarray(1.0, dt), jnp.where(f == 0, jnp.asarray(0.0, dt), c_gen))
    s = jnp.where(g == 0, jnp.asarray(0.0, dt), jnp.where(f == 0, sgn_g, s_gen))
    r = jnp.where(g == 0, f, jnp.where(f == 0, ag, r_gen))
    return c, s, r


def givens_complex(f, g):
    """Complex Givens: (c, s, r); c real >= 0, s, r complex.

    ``[c s; -conj(s) c] @ [f, g] = [r, 0]``.
    g == 0 -> (1, 0, f) exactly; f == 0 -> (0, conj(g)/|g|, |g|).
    """
    f = jnp.asarray(f)
    g = jnp.asarray(g)
    dt = jnp.promote_types(jnp.result_type(f, g), jnp.complex64)
    rdt = jnp.finfo(dt).dtype
    f = f.astype(dt)
    g = g.astype(dt)
    one = jnp.asarray(1.0, rdt)
    zero = jnp.asarray(0.0, rdt)
    scale = jnp.maximum(
        jnp.maximum(jnp.abs(f.real), jnp.abs(f.imag)),
        jnp.maximum(jnp.abs(g.real), jnp.abs(g.imag)),
    )
    sc = jnp.where(scale == 0, one, scale)
    fs = jax.lax.complex(f.real / sc, f.imag / sc)
    gs = jax.lax.complex(g.real / sc, g.imag / sc)
    d2 = (fs * jnp.conj(fs) + gs * jnp.conj(gs)).real
    af = jnp.sqrt((fs * jnp.conj(fs)).real)
    d = jnp.sqrt(d2)
    dsafe = jnp.where(d == 0, one, d)
    afsafe = jnp.where(af == 0, one, af)
    c_gen = af / dsafe
    fsign = jax.lax.complex(fs.real / afsafe, fs.imag / afsafe)
    r_gen = fsign * d * sc
    sg_num = fsign * jnp.conj(gs)
    s_gen = jax.lax.complex(sg_num.real / dsafe, sg_num.imag / dsafe)

    ag = jnp.sqrt((gs * jnp.conj(gs)).real)
    agsafe = jnp.where(ag == 0, one, ag)
    s_f0 = jax.lax.complex(gs.real / agsafe, -gs.imag / agsafe)
    r_f0 = (ag * sc).astype(dt)

    g_is0 = (g.real == 0) & (g.imag == 0)
    f_is0 = (f.real == 0) & (f.imag == 0)
    c = jnp.where(g_is0, one, jnp.where(f_is0, zero, c_gen))
    s = jnp.where(g_is0, jnp.asarray(0.0, dt), jnp.where(f_is0, s_f0, s_gen))
    r = jnp.where(g_is0, f, jnp.where(f_is0, r_f0, r_gen))
    return c, s, r


def givens(f, g):
    """Dispatch to the real/complex generator based on dtype."""
    if jnp.issubdtype(jnp.result_type(f, g), jnp.complexfloating):
        return givens_complex(f, g)
    return givens_real(f, g)


# -----------------------------------------------------------------------------
# 2x2 builders.  ``c`` real, ``s`` may be complex; output dtype follows ``s``.


def _m2(a, b, c, d, dt):
    return jnp.stack(
        [jnp.stack([jnp.asarray(a, dt), jnp.asarray(b, dt)]),
         jnp.stack([jnp.asarray(c, dt), jnp.asarray(d, dt)])]
    )


def lmat(c, s):
    """Left action of G(i, i+1, c, s) on the row pair: [[c, s], [-s̄, c̄]]."""
    dt = jnp.result_type(c, s)
    return _m2(c, s, -jnp.conj(s), jnp.conj(c), dt)


def rmat_adj(c, s):
    """Right action of G(i, i+1, c, s)' on the column pair: [[c, -s], [s̄, c̄]].

    new_cols = old_cols @ rmat_adj(c, s); equals lmat(c, s)ᴴ.
    """
    dt = jnp.result_type(c, s)
    return _m2(c, -s, jnp.conj(s), jnp.conj(c), dt)


# -----------------------------------------------------------------------------
# Masked pair application


def rowsk(H, i, M, lo=None, hi=None, active=None):
    """k-row slab update: H[i:i+k, lo:hi] = M @ H[i:i+k, lo:hi]; k = M.shape[0].

    ``i, lo, hi`` may be traced; ``i`` is clamped to [0, m-k].  ``active``
    (scalar bool) disables the whole update (used to mask loop iterations).
    Caller must ensure that whenever ``active`` is true, ``i <= m-k`` (pad the
    array with ghost rows if an algorithm needs a k-slab near the bottom).
    """
    k = M.shape[0]
    m, n = H.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - k)
    rows = lax.dynamic_slice(H, (i, jnp.int32(0)), (k, n))
    new = M.astype(H.dtype) @ rows
    if lo is not None or hi is not None:
        col = lax.iota(jnp.int32, n)
        mask = jnp.ones((n,), bool)
        if lo is not None:
            mask &= col >= lo
        if hi is not None:
            mask &= col < hi
        new = jnp.where(mask[None, :], new, rows)
    if active is not None:
        new = jnp.where(active, new, rows)
    return lax.dynamic_update_slice(H, new, (i, jnp.int32(0)))


def colsk(H, j, M, lo=None, hi=None, active=None):
    """k-column slab update: H[lo:hi, j:j+k] = H[lo:hi, j:j+k] @ M."""
    k = M.shape[0]
    m, n = H.shape
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - k)
    cols = lax.dynamic_slice(H, (jnp.int32(0), j), (m, k))
    new = cols @ M.astype(H.dtype)
    if lo is not None or hi is not None:
        row = lax.iota(jnp.int32, m)
        mask = jnp.ones((m,), bool)
        if lo is not None:
            mask &= row >= lo
        if hi is not None:
            mask &= row < hi
        new = jnp.where(mask[:, None], new, cols)
    if active is not None:
        new = jnp.where(active, new, cols)
    return lax.dynamic_update_slice(H, new, (jnp.int32(0), j))


rows2 = rowsk
cols2 = colsk


def set2(H, i, j, vals, active=None):
    """Masked scalar write of a (2,)-pair H[i, j:j+2] = vals (row fragment)."""
    m, n = H.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - 1)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - 2)
    old = lax.dynamic_slice(H, (i, j), (1, 2))
    new = vals.reshape(1, 2).astype(H.dtype)
    if active is not None:
        new = jnp.where(active, new, old)
    return lax.dynamic_update_slice(H, new, (i, j))


def getel(H, i, j):
    """Clamped traced-scalar read H[i, j]."""
    m, n = H.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - 1)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - 1)
    return lax.dynamic_slice(H, (i, j), (1, 1))[0, 0]


def setel(H, i, j, val, active=None):
    """Clamped traced-scalar write H[i, j] = val (masked by ``active``)."""
    m, n = H.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - 1)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - 1)
    old = lax.dynamic_slice(H, (i, j), (1, 1))
    new = jnp.asarray(val, H.dtype).reshape(1, 1)
    if active is not None:
        new = jnp.where(active, new, old)
    return lax.dynamic_update_slice(H, new, (i, j))


def getcol(H, i, j, k):
    """Clamped (k,) column fragment H[i:i+k, j] (one slice op)."""
    m, n = H.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - k)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - 1)
    return lax.dynamic_slice(H, (i, j), (k, 1))[:, 0]


def setcol(H, i, j, vals, active=None):
    """Masked write of a (k,) column fragment H[i:i+k, j] (one update op)."""
    k = vals.shape[0]
    m, n = H.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - k)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - 1)
    new = vals.reshape(k, 1).astype(H.dtype)
    if active is not None:
        old = lax.dynamic_slice(H, (i, j), (k, 1))
        new = jnp.where(active, new, old)
    return lax.dynamic_update_slice(H, new, (i, j))


def getrow(H, i, j, k):
    """Clamped (k,) row fragment H[i, j:j+k] (one slice op)."""
    m, n = H.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - 1)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - k)
    return lax.dynamic_slice(H, (i, j), (1, k))[0, :]


def setrow(H, i, j, vals, active=None):
    """Masked write of a (k,) row fragment H[i, j:j+k] (one update op)."""
    k = vals.shape[0]
    m, n = H.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - 1)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - k)
    new = vals.reshape(1, k).astype(H.dtype)
    if active is not None:
        old = lax.dynamic_slice(H, (i, j), (1, k))
        new = jnp.where(active, new, old)
    return lax.dynamic_update_slice(H, new, (i, j))
