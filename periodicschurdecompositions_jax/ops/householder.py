"""Householder reflector generation and application.

Generation has LAPACK xLARFG semantics, including the underflow-rescue
rescaling (behavioral contract from the reference's `_xreflector!`,
src/householder.jl:66-156, which deliberately replaces Julia's stdlib
reflector for accuracy).  A reflector is represented as

    P = I - tau * w @ w^H,   w[first] = 1,

with ``P^H @ x = [beta, 0, ..., 0]`` on the active window (LAPACK
convention: for real dtypes P is symmetric so P @ x works too; for complex
apply the adjoint, i.e. pass ``conj(tau)`` to :func:`refl_left`).  ``tau``
is possibly complex; complex inputs also realify beta.

Two shapes of generator are provided:

* :func:`reflector_masked` — full-length vector with a traced window
  ``[lo, hi)``; used by the periodic Hessenberg reduction where windows
  shrink but shapes must stay static.
* :func:`reflector_small` — tiny static-size vectors (2 or 3 slots) for the
  bulge-chase kernels; an inactive trailing slot is simply zeroed by the
  caller.

Application of small reflectors is via explicit k x k matrices fed to
``rotations.rowsk/colsk`` slab updates; full-size application is a rank-1
update (two matvecs).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _safemin(rdt) -> float:
    fi = jnp.finfo(rdt)
    return float(2.0 * fi.tiny / fi.eps)


def _scaled_norm(x2, mask=None):
    """Overflow/underflow-safe 2-norm of a (real-squared-sum over) vector.

    ``x2``: elementwise |x|^2 is NOT passed; we take x itself (real or
    complex) and return its masked 2-norm using max-scaling.
    """
    a = jnp.abs(x2)
    if mask is not None:
        a = jnp.where(mask, a, 0.0)
    m = jnp.max(a) if a.ndim else a
    msafe = jnp.where(m == 0, 1.0, m)
    ssq = jnp.sum((a / msafe) ** 2)
    return m * jnp.sqrt(ssq)


def _copysign(mag, sgn):
    return jnp.where(sgn >= 0, jnp.abs(mag), -jnp.abs(mag))


def _reflector_from(alpha, tail, tail_mask, dt):
    """Shared xLARFG core: returns (beta, tau, scaled_tail, trivial).

    ``tail`` is the essential part (any static length) with ``tail_mask``
    selecting active entries; inactive entries must already be zero in the
    caller's data or are zeroed here.
    """
    rdt = jnp.finfo(dt).dtype
    cplx = jnp.issubdtype(dt, jnp.complexfloating)
    sfmin = jnp.asarray(_safemin(rdt), rdt)
    rsfmin = 1.0 / sfmin

    tail = jnp.where(tail_mask, tail, jnp.zeros((), dt))
    xnorm = _scaled_norm(tail)
    ar = alpha.real if cplx else alpha
    ai = alpha.imag if cplx else jnp.zeros((), rdt)

    trivial = (xnorm == 0) & (ai == 0)

    def hyp3(x, y, z):
        m = jnp.maximum(jnp.maximum(jnp.abs(x), jnp.abs(y)), jnp.abs(z))
        ms = jnp.where(m == 0, 1.0, m)
        return m * jnp.sqrt((x / ms) ** 2 + (y / ms) ** 2 + (z / ms) ** 2)

    beta = -_copysign(hyp3(ar, ai, xnorm), ar)

    # single-round underflow rescue (sufficient for binary32/64: one multiply
    # by 1/sfmin brings any nonzero |beta| above sfmin)
    need = jnp.abs(beta) < sfmin
    scl = jnp.where(need, rsfmin, jnp.ones((), rdt))
    tail = tail * scl
    ar = ar * scl
    ai = ai * scl
    xnorm2 = _scaled_norm(tail)
    beta2 = -_copysign(hyp3(ar, ai, xnorm2), ar)
    beta_in = jnp.where(need, beta2, beta)

    bsafe = jnp.where(beta_in == 0, jnp.ones((), rdt), beta_in)
    if cplx:
        tau = (beta_in - ar) / bsafe - 1j * (ai / bsafe)
        alpha_s = ar + 1j * ai
    else:
        tau = (beta_in - ar) / bsafe
        alpha_s = ar
    denom = alpha_s - beta_in
    dsafe = jnp.where(denom == 0, jnp.ones((), dt), denom.astype(dt))
    if cplx:
        d2 = (dsafe * jnp.conj(dsafe)).real
        inv = jax.lax.complex(jnp.conj(dsafe).real / d2,
                              jnp.conj(dsafe).imag / d2)
        vtail = tail * inv
    else:
        vtail = tail / dsafe
    beta_out = jnp.where(need, beta_in * sfmin, beta_in)

    zero_t = jnp.zeros((), dt)
    tau = jnp.where(trivial, zero_t, tau.astype(dt))
    vtail = jnp.where(trivial, jnp.zeros_like(vtail), vtail)
    beta_out = jnp.where(trivial, alpha.real if cplx else alpha, beta_out)
    return beta_out.astype(rdt), tau, vtail


def reflector_masked(x, lo, hi=None):
    """xLARFG on the window ``x[lo:hi]`` of a static-length vector.

    Returns ``(w, tau, beta)``: full-length ``w`` with ``w[lo] = 1``, the
    essential part in ``(lo, hi)`` and zeros elsewhere; ``tau`` scalar; and
    real ``beta`` (the value that replaces ``x[lo]``; for complex input beta
    is realified like LAPACK).  ``lo``/``hi`` may be traced.
    """
    n = x.shape[0]
    dt = x.dtype
    if hi is None:
        hi = n
    idx = lax.iota(jnp.int32, n)
    inwin = (idx >= lo) & (idx < hi)
    alpha = jnp.sum(jnp.where(idx == lo, x, jnp.zeros((), dt)))
    tail_mask = (idx > lo) & (idx < hi)
    beta, tau, vtail = _reflector_from(alpha, x, tail_mask, dt)
    w = jnp.where(tail_mask, vtail, jnp.zeros((), dt))
    w = jnp.where(idx == lo, jnp.ones((), dt), w)
    w = jnp.where(inwin, w, jnp.zeros((), dt))
    return w, tau, beta


def reflector_small(x):
    """xLARFG on a tiny static vector (first element is the pivot).

    Inactive trailing slots must be zero.  Returns ``(w, tau, beta)`` with
    ``w[0] = 1``.
    """
    dt = x.dtype
    alpha = x[0]
    tail = x[1:]
    beta, tau, vtail = _reflector_from(alpha, tail, jnp.ones(tail.shape, bool), dt)
    w = jnp.concatenate([jnp.ones((1,), dt), vtail])
    return w, tau, beta


def refl_mat(w, tau):
    """Dense k x k matrix ``I - tau w w^H`` for a small reflector."""
    k = w.shape[0]
    return jnp.eye(k, dtype=w.dtype) - tau * jnp.outer(w, jnp.conj(w))


def refl_left(A, w, tau):
    """A <- (I - tau w w^H) @ A  (full-size rank-1 update; w masked)."""
    t = jnp.conj(w) @ A
    return A - tau * jnp.outer(w, t)


def refl_right(A, w, tau):
    """A <- A @ (I - tau w w^H)."""
    t = A @ w
    return A - tau * jnp.outer(t, jnp.conj(w))
