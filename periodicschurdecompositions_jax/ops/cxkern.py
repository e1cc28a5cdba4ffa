"""Split-complex kernels: complex arrays as (re, im) float64 pairs.

Every complex array is a ``CX(re, im)`` pair of real float64 arrays, and
all kernels used by the split-complex QZ iteration (ops/pqz_complex_split.py)
are reimplemented on the pair: robust Givens generation (zlartg semantics,
mirroring ops/rotations.givens_complex), 2x2 rotation builders, masked
row/column slab updates, complex Householder reflectors.  The arithmetic is
plain IEEE float64, so results agree with the complex128 core to roundoff.

Reference parity: same numerical contracts as the complex element ops the
reference uses through Julia's LinearAlgebra (givensAlgorithm,
reflector semantics of /root/reference/src/householder.jl:110-156).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class CX(NamedTuple):
    """Unevaluated complex value re + i*im as two real arrays."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype


# ---------------------------------------------------------------------------
# construction / conversion


def cx(re, im=None) -> CX:
    re = jnp.asarray(re)
    if im is None:
        im = jnp.zeros_like(re)
    return CX(re, jnp.asarray(im, re.dtype))


def from_c(x) -> CX:
    """Split a complex jax/numpy array (host-side staging only)."""
    x = jnp.asarray(x)
    return CX(jnp.real(x), jnp.imag(x))


def to_c(x: CX):
    """Assemble a complex array (CPU-side; complex128 is host-only)."""
    return lax.complex(x.re, x.im)


def zeros(shape, dt) -> CX:
    z = jnp.zeros(shape, dt)
    return CX(z, z)


def full_like(x: CX, re, im=0.0) -> CX:
    return CX(jnp.full_like(x.re, re), jnp.full_like(x.im, im))


# ---------------------------------------------------------------------------
# arithmetic


def add(a: CX, b: CX) -> CX:
    return CX(a.re + b.re, a.im + b.im)


def sub(a: CX, b: CX) -> CX:
    return CX(a.re - b.re, a.im - b.im)


def neg(a: CX) -> CX:
    return CX(-a.re, -a.im)


def conj(a: CX) -> CX:
    return CX(a.re, -a.im)


def mul(a: CX, b: CX) -> CX:
    return CX(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def mul_real(a: CX, r) -> CX:
    return CX(a.re * r, a.im * r)


def is0(a: CX):
    return (a.re == 0) & (a.im == 0)


def cabs(a: CX):
    """Robust |a| (max-scaled hypot)."""
    m = jnp.maximum(jnp.abs(a.re), jnp.abs(a.im))
    ms = jnp.where(m == 0, jnp.ones_like(m), m)
    xr = a.re / ms
    xi = a.im / ms
    return m * jnp.sqrt(xr * xr + xi * xi)


def abs1(a: CX):
    """|re| + |im| (the cheap 1-norm magnitude the tolerances use)."""
    return jnp.abs(a.re) + jnp.abs(a.im)


def div(a: CX, b: CX) -> CX:
    """a / b, Smith-style scaling; b == 0 passes through (caller guards)."""
    d = b.re * b.re + b.im * b.im
    ds = jnp.where(d == 0, jnp.ones_like(d), d)
    return CX((a.re * b.re + a.im * b.im) / ds,
              (a.im * b.re - a.re * b.im) / ds)


def where(m, a: CX, b: CX) -> CX:
    return CX(jnp.where(m, a.re, b.re), jnp.where(m, a.im, b.im))


# ---------------------------------------------------------------------------
# Givens generation (zlartg semantics; mirrors rotations.givens_complex
# branch for branch so the split path is test-comparable against it)


def givens_cx(f: CX, g: CX):
    """(c, s, r): c real >= 0, s/r CX, [c s; -conj(s) c] @ [f, g] = [r, 0].

    g == 0 -> (1, 0, f) exactly; f == 0 -> (0, conj(g)/|g|, |g|).
    """
    rdt = f.re.dtype
    one = jnp.asarray(1.0, rdt)
    zero = jnp.asarray(0.0, rdt)
    scale = jnp.maximum(jnp.maximum(jnp.abs(f.re), jnp.abs(f.im)),
                        jnp.maximum(jnp.abs(g.re), jnp.abs(g.im)))
    sc = jnp.where(scale == 0, one, scale)
    fs = CX(f.re / sc, f.im / sc)
    gs = CX(g.re / sc, g.im / sc)
    f2 = fs.re * fs.re + fs.im * fs.im
    g2 = gs.re * gs.re + gs.im * gs.im
    d2 = f2 + g2
    af = jnp.sqrt(f2)
    d = jnp.sqrt(d2)
    dsafe = jnp.where(d == 0, one, d)
    afsafe = jnp.where(af == 0, one, af)
    c_gen = af / dsafe
    fsign = CX(fs.re / afsafe, fs.im / afsafe)
    r_gen = mul_real(fsign, d * sc)
    sg_num = mul(fsign, conj(gs))
    s_gen = CX(sg_num.re / dsafe, sg_num.im / dsafe)

    ag = jnp.sqrt(g2)
    agsafe = jnp.where(ag == 0, one, ag)
    s_f0 = CX(gs.re / agsafe, -gs.im / agsafe)
    r_f0 = CX(ag * sc, jnp.zeros_like(ag))

    g_is0 = is0(g)
    f_is0 = is0(f)
    c = jnp.where(g_is0, one, jnp.where(f_is0, zero, c_gen))
    s = where(g_is0, zeros(s_gen.shape, rdt), where(f_is0, s_f0, s_gen))
    r = where(g_is0, f, where(f_is0, r_f0, r_gen))
    return c, s, r


# ---------------------------------------------------------------------------
# 2x2 builders: (c real, s CX) -> 2x2 CX matrix


def _m2r(a, b, c, d, dt):
    return jnp.stack([jnp.stack([jnp.asarray(a, dt), jnp.asarray(b, dt)]),
                      jnp.stack([jnp.asarray(c, dt), jnp.asarray(d, dt)])])


def lmat_cx(c, s: CX) -> CX:
    """Row-pair left action [[c, s], [-conj(s), c]] (c real)."""
    dt = s.re.dtype
    z = jnp.zeros((), dt)
    return CX(_m2r(c, s.re, -s.re, c, dt), _m2r(z, s.im, s.im, z, dt))


def rmat_adj_cx(c, s: CX) -> CX:
    """Column-pair right action of G': [[c, -s], [conj(s), c]]."""
    dt = s.re.dtype
    z = jnp.zeros((), dt)
    return CX(_m2r(c, -s.re, s.re, c, dt), _m2r(z, -s.im, -s.im, z, dt))


def matmul_cx(A: CX, B: CX) -> CX:
    return CX(A.re @ B.re - A.im @ B.im, A.re @ B.im + A.im @ B.re)


# ---------------------------------------------------------------------------
# masked slab updates (mirrors ops/rotations.py rowsk/colsk/... on pairs)


def _ds(H: CX, start, sizes) -> CX:
    return CX(lax.dynamic_slice(H.re, start, sizes),
              lax.dynamic_slice(H.im, start, sizes))


def _dus(H: CX, vals: CX, start) -> CX:
    return CX(lax.dynamic_update_slice(H.re, vals.re, start),
              lax.dynamic_update_slice(H.im, vals.im, start))


def rowsk_cx(H: CX, i, M: CX, lo=None, hi=None, active=None) -> CX:
    """H[i:i+k, lo:hi] = M @ H[i:i+k, lo:hi]; i/lo/hi traced."""
    k = M.re.shape[0]
    m, n = H.re.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - k)
    rows = _ds(H, (i, jnp.int32(0)), (k, n))
    new = matmul_cx(M, rows)
    if lo is not None or hi is not None:
        col = lax.iota(jnp.int32, n)
        mask = jnp.ones((n,), bool)
        if lo is not None:
            mask &= col >= lo
        if hi is not None:
            mask &= col < hi
        new = where(mask[None, :], new, rows)
    if active is not None:
        new = where(active, new, rows)
    return _dus(H, new, (i, jnp.int32(0)))


def colsk_cx(H: CX, j, M: CX, lo=None, hi=None, active=None) -> CX:
    """H[lo:hi, j:j+k] = H[lo:hi, j:j+k] @ M."""
    k = M.re.shape[0]
    m, n = H.re.shape
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - k)
    cols = _ds(H, (jnp.int32(0), j), (m, k))
    new = matmul_cx(cols, M)
    if lo is not None or hi is not None:
        row = lax.iota(jnp.int32, m)
        mask = jnp.ones((m,), bool)
        if lo is not None:
            mask &= row >= lo
        if hi is not None:
            mask &= row < hi
        new = where(mask[:, None], new, cols)
    if active is not None:
        new = where(active, new, cols)
    return _dus(H, new, (jnp.int32(0), j))


def getel_cx(H: CX, i, j) -> CX:
    m, n = H.re.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - 1)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - 1)
    v = _ds(H, (i, j), (1, 1))
    return CX(v.re[0, 0], v.im[0, 0])


def setel_cx(H: CX, i, j, val: CX, active=None) -> CX:
    m, n = H.re.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - 1)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - 1)
    old = _ds(H, (i, j), (1, 1))
    new = CX(jnp.reshape(val.re, (1, 1)), jnp.reshape(val.im, (1, 1)))
    if active is not None:
        new = where(active, new, old)
    return _dus(H, new, (i, j))


def getcol_cx(H: CX, i, j, k) -> CX:
    m, n = H.re.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - k)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - 1)
    v = _ds(H, (i, j), (k, 1))
    return CX(v.re[:, 0], v.im[:, 0])


def setcol_cx(H: CX, i, j, vals: CX, active=None) -> CX:
    k = vals.re.shape[0]
    m, n = H.re.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - k)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - 1)
    new = CX(vals.re.reshape(k, 1), vals.im.reshape(k, 1))
    if active is not None:
        old = _ds(H, (i, j), (k, 1))
        new = where(active, new, old)
    return _dus(H, new, (i, j))


def getrow_cx(H: CX, i, j, k) -> CX:
    m, n = H.re.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - 1)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - k)
    v = _ds(H, (i, j), (1, k))
    return CX(v.re[0, :], v.im[0, :])


def setrow_cx(H: CX, i, j, vals: CX, active=None) -> CX:
    k = vals.re.shape[0]
    m, n = H.re.shape
    i = jnp.clip(jnp.asarray(i, jnp.int32), 0, m - 1)
    j = jnp.clip(jnp.asarray(j, jnp.int32), 0, n - k)
    new = CX(vals.re.reshape(1, k), vals.im.reshape(1, k))
    if active is not None:
        old = _ds(H, (i, j), (1, k))
        new = where(active, new, old)
    return _dus(H, new, (i, j))


def fac_get(H: CX, f) -> CX:
    p, m, n = H.re.shape
    f = jnp.clip(jnp.asarray(f, jnp.int32), 0, p - 1)
    z = jnp.int32(0)
    v = _ds(H, (f, z, z), (1, m, n))
    return CX(v.re[0], v.im[0])


def fac_set(H: CX, f, M: CX) -> CX:
    p, m, n = H.re.shape
    f = jnp.clip(jnp.asarray(f, jnp.int32), 0, p - 1)
    z = jnp.int32(0)
    return CX(lax.dynamic_update_slice(H.re, M.re[None], (f, z, z)),
              lax.dynamic_update_slice(H.im, M.im[None], (f, z, z)))


def at_set(H: CX, idx, M: CX) -> CX:
    return CX(H.re.at[idx].set(M.re), H.im.at[idx].set(M.im))


# ---------------------------------------------------------------------------
# complex Householder reflector (xLARFG semantics; reference
# src/householder.jl:110-156 contract) for the split reduction


def reflector_masked_cx(x: CX, start):
    """Reflector annihilating x[start+1:], acting on rows >= start.

    Returns (w: CX with w[start] = 1 and zeros before start, tau: CX,
    beta: CX real-valued) with (I - tau w w^H) x = beta e_start.
    """
    n = x.re.shape[0]
    rdt = x.re.dtype
    rows = lax.iota(jnp.int32, n)
    m_tail = rows > start
    m_head = rows >= start
    alpha = CX(jnp.sum(jnp.where(rows == start, x.re, 0.0)),
               jnp.sum(jnp.where(rows == start, x.im, 0.0)))
    xn2 = jnp.sum(jnp.where(m_tail, x.re * x.re + x.im * x.im, 0.0))
    aab = jnp.sqrt(alpha.re * alpha.re + alpha.im * alpha.im + xn2)
    # beta = -sign(Re(alpha)) * |[alpha; x]|  (real by construction)
    beta_v = jnp.where(alpha.re >= 0, -aab, aab)
    degenerate = (xn2 == 0) & (alpha.im == 0)
    beta = jnp.where(degenerate, alpha.re, beta_v)
    # tau = (beta - alpha) / beta
    bsafe = jnp.where(beta == 0, 1.0, beta)
    tau = CX((beta - alpha.re) / bsafe, -alpha.im / bsafe)
    tau = where(degenerate, zeros((), rdt), tau)
    # w tail = x / (alpha - beta)
    denom = CX(alpha.re - beta, alpha.im)
    d2 = denom.re * denom.re + denom.im * denom.im
    d2s = jnp.where(d2 == 0, 1.0, d2)
    wre = (x.re * denom.re + x.im * denom.im) / d2s
    wim = (x.im * denom.re - x.re * denom.im) / d2s
    w = CX(jnp.where(m_tail, wre, 0.0) + jnp.where(rows == start, 1.0, 0.0),
           jnp.where(m_tail, wim, 0.0))
    w = where(degenerate, CX(jnp.where(rows == start, 1.0, 0.0),
                             jnp.zeros((n,), rdt)), w)
    del m_head
    return w, tau, CX(beta, jnp.zeros((), rdt))


def refl_left_cx(A: CX, w: CX, tau_conj: CX) -> CX:
    """A <- (I - conj(tau) w w^H)^H ... matching refl_left semantics:
    A -= tau_conj * w (w^H A)  (caller passes conj(tau) like the f64 path)."""
    # v = w^H A  (1 x n):  sum_k conj(w_k) A[k, :]
    vre = w.re @ A.re + w.im @ A.im
    vim = w.re @ A.im - w.im @ A.re
    tv = CX(tau_conj.re * vre - tau_conj.im * vim,
            tau_conj.re * vim + tau_conj.im * vre)
    return CX(A.re - (w.re[:, None] * tv.re[None, :] -
                      w.im[:, None] * tv.im[None, :]),
              A.im - (w.re[:, None] * tv.im[None, :] +
                      w.im[:, None] * tv.re[None, :]))


def refl_right_cx(A: CX, w: CX, tau: CX) -> CX:
    """A <- A (I - tau w w^H):  A -= (A w) tau w^H."""
    vre = A.re @ w.re - A.im @ w.im
    vim = A.re @ w.im + A.im @ w.re
    tv = CX(vre * tau.re - vim * tau.im, vre * tau.im + vim * tau.re)
    # outer (tv) (w^H):  tv_i * conj(w_j)
    return CX(A.re - (tv.re[:, None] * w.re[None, :] +
                      tv.im[:, None] * w.im[None, :]),
              A.im - (tv.im[:, None] * w.re[None, :] -
                      tv.re[:, None] * w.im[None, :]))
