"""Periodic Hessenberg reduction (all-positive signature).

Behavioral contract from the reference's `phessenberg!`
(src/PeriodicSchurDecompositions.jl:199-259, an MB03VD-style column sweep):
reduce a cycle ``A[0..p-1]`` by unitary similarity

    Q[j]^H A[j] Q[(j+1) % p] = H[j]

with ``H[0]`` upper Hessenberg and ``H[1..p-1]`` upper triangular.

Design: one ``lax.fori_loop`` over columns; for each column the p-cycle of
reflector generate/apply steps is unrolled (p is static).  Every reflector
application is a full-width rank-1 update (two matvecs), which XLA fuses —
there are no shrinking submatrices, the reflector vectors carry the
masking.  Complexity O(p n^3) like the reference,
but each flop lives in a large fused matvec instead of a scalar loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .householder import refl_left, refl_right, reflector_masked
from functools import partial


def _fix_column(M, i, beta, zero_below):
    """Set column i to the reflector's exact image: rows<zero_below kept,
    row ``zero_below-1`` = beta, rows >= zero_below zeroed."""
    n = M.shape[0]
    i = jnp.asarray(i, jnp.int32)
    col = lax.dynamic_slice(M, (jnp.int32(0), i), (n, 1))[:, 0]
    rows = lax.iota(jnp.int32, n)
    piv = zero_below - 1
    newcol = jnp.where(rows < piv, col,
                       jnp.where(rows == piv, jnp.asarray(beta, M.dtype),
                                 jnp.zeros((), M.dtype)))
    return lax.dynamic_update_slice(M, newcol[:, None], (jnp.int32(0), i))


@partial(jax.jit, static_argnames=("want_q",))
def phessenberg_core(A: jax.Array, want_q: bool = True
                     ) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Reduce a stacked cycle to periodic Hessenberg/triangular form.

    Args:
      A: (p, n, n) stacked cycle (real or complex floating dtype).
      want_q: accumulate the unitary factors.

    Returns:
      (H, Q): H is (p, n, n) with H[0] upper Hessenberg and H[1:] upper
      triangular; Q is (p, n, n) with Q[j]^H A[j] Q[(j+1)%p] = H[j]
      (or None if not requested).
    """
    p, n, n2 = A.shape
    assert n == n2, "factors must be square"
    dt = A.dtype
    if n <= 1:
        Q = jnp.broadcast_to(jnp.eye(n, dtype=dt), (p, n, n)) if want_q else None
        return A, Q

    Q0 = jnp.broadcast_to(jnp.eye(n, dtype=dt), (p, n, n)).copy() if want_q else None

    def column_step(i, carry):
        A, Q = carry
        # factors p-1 .. 1: triangularize column i
        for j in range(p - 1, 0, -1):
            col = lax.dynamic_slice(A[j], (jnp.int32(0), jnp.asarray(i, jnp.int32)),
                                    (n, 1))[:, 0]
            w, tau, beta = reflector_masked(col, i)
            Aj = refl_left(A[j], w, jnp.conj(tau))
            Aj = _fix_column(Aj, i, beta, i + 1)
            A = A.at[j].set(Aj)
            A = A.at[j - 1].set(refl_right(A[j - 1], w, tau))
            if want_q:
                Q = Q.at[j].set(refl_right(Q[j], w, tau))
        # factor 0: Hessenberg column i (annihilate below row i+1)
        col = lax.dynamic_slice(A[0], (jnp.int32(0), jnp.asarray(i, jnp.int32)),
                                (n, 1))[:, 0]
        w, tau, beta = reflector_masked(col, i + 1)
        A0 = refl_left(A[0], w, jnp.conj(tau))
        A0 = _fix_column(A0, i, beta, i + 2)
        A = A.at[0].set(A0)
        A = A.at[p - 1 if p > 1 else 0].set(refl_right(A[p - 1 if p > 1 else 0], w, tau))
        if want_q:
            Q = Q.at[0].set(refl_right(Q[0], w, tau))
        return A, Q

    # note the p == 1 subtlety: the right-coupling of factor 0 wraps onto
    # itself, which column_step handles by indexing factor p-1 == 0 after the
    # left application (same as the reference's cyclic coupling).
    A, Q0 = lax.fori_loop(0, n - 1, column_step, (A, Q0))

    # scrub roundoff outside the guaranteed-zero structure (the reference
    # does the same via triu, src/PeriodicSchurDecompositions.jl:149)
    tri = jnp.triu(A[1:], 0) if p > 1 else A[1:]
    H = jnp.concatenate([jnp.triu(A[:1], -1), tri], axis=0)
    return H, Q0


def _rq(A):
    """RQ decomposition A = R @ Q via a flipped QR (R upper tri, Q unitary)."""
    B = A[::-1, :].conj().T          # B = A^H J
    Q1, R1 = jnp.linalg.qr(B)
    R = R1.conj().T[::-1, ::-1]      # J R1^H J: upper triangular
    Q = Q1.conj().T[::-1, :]         # J Q1^H
    return R, Q


@partial(jax.jit, static_argnames=("S", "want_q"))
def phessenberg_signed_core(A: jax.Array, S, want_q: bool = True
                            ) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Generalized periodic Hessenberg-triangular reduction (mixed signature).

    Behavioral contract from the reference's `_phessenberg!`
    (src/generalized.jl:988-1179, Kressner-2001 two-stage scheme): stage 1
    triangularizes factors p-1..1 by QR (direct factors) or RQ (inverted
    factors), propagating the unitary into the neighbor according to its
    sign; stage 2 reduces factor 0 to Hessenberg with Givens chains,
    re-triangularizing each factor (direct: QR-like rotation; inverted:
    RQ-like rotation).

    Requires ``S[0] = True``.  Returns (H, Q) with H[0] Hessenberg, H[1:]
    triangular, and ``Q[l]^H A[l] Q[(l+1)%p] = H[l]`` for S[l] else
    ``Q[(l+1)%p]^H A[l] Q[l] = H[l]``.
    """
    p, n, _ = A.shape
    assert S[0], "signature entry S[0] must be True"
    dt = A.dtype
    Q0 = jnp.broadcast_to(jnp.eye(n, dtype=dt), (p, n, n)).copy() if want_q else None

    # ---- stage 1: triangular decompositions (QR / RQ) -------------------
    for l in range(p - 1, 0, -1):
        if S[l]:
            Qf, R = jnp.linalg.qr(A[l])
            A = A.at[l].set(R)
            if S[l - 1]:
                A = A.at[l - 1].set(A[l - 1] @ Qf)
            else:
                A = A.at[l - 1].set(Qf.conj().T @ A[l - 1])
            if want_q:
                Q0 = Q0.at[l].set(Q0[l] @ Qf)
        else:
            R, Qf = _rq(A[l])
            A = A.at[l].set(R)
            if S[l - 1]:
                A = A.at[l - 1].set(A[l - 1] @ Qf.conj().T)
            else:
                A = A.at[l - 1].set(Qf @ A[l - 1])
            if want_q:
                Q0 = Q0.at[l].set(Q0[l] @ Qf.conj().T)

    if n <= 2:
        tri = jnp.triu(A[1:], 0) if p > 1 else A[1:]
        H = jnp.concatenate([jnp.triu(A[:1], -1), tri], axis=0)
        return H, Q0

    # ---- stage 2: Givens Hessenberg reduction of factor 0 ---------------
    from .rotations import colsk, getel, givens, lmat, rmat_adj, rowsk, setel
    cplx = jnp.issubdtype(dt, jnp.complexfloating)
    rdt = jnp.finfo(dt).dtype
    zero = jnp.zeros((), dt)

    def col_step(j, carry):
        A, Q = carry
        Gc0 = jnp.ones((n,), rdt)
        Gs0 = jnp.zeros((n,), dt)

        def chain_desc(M, Gc, Gs, lo_i, base_off=1):
            """Apply stored rotations (pair (i-1, i)) descending to columns."""
            def bd(t, M):
                i = n - 1 - t
                act = i >= lo_i
                return colsk(M, i - 1, rmat_adj(Gc[i], Gs[i]), active=act)
            return lax.fori_loop(0, n, bd, M)

        def a_step(t, carry):
            A0, Gc, Gs = carry
            i = n - 1 - t
            act = i >= j + 2
            c, s, r = givens(getel(A0, i - 1, j), getel(A0, i, j))
            A0 = setel(A0, i - 1, j, r, active=act)
            A0 = setel(A0, i, j, zero, active=act)
            A0 = rowsk(A0, i - 1, lmat(c, s), lo=j + 1, active=act)
            Gc = Gc.at[i].set(jnp.where(act, c, Gc[i]))
            Gs = Gs.at[i].set(jnp.where(act, s, Gs[i]))
            return A0, Gc, Gs

        A0, Gc, Gs = lax.fori_loop(0, n, a_step, (A[0], Gc0, Gs0))
        A = A.at[0].set(A0)
        if want_q:
            Q = Q.at[0].set(chain_desc(Q[0], Gc, Gs, j + 2))

        for l in range(p - 1, 0, -1):
            if S[l]:
                def b_step(t, carry, l=l):
                    Al, Gc, Gs = carry
                    i = n - 1 - t
                    act = i >= j + 2
                    Al = colsk(Al, i - 1, rmat_adj(Gc[i], Gs[i]), hi=i + 1,
                               active=act)
                    c, s, r = givens(getel(Al, i - 1, i - 1), getel(Al, i, i - 1))
                    Al = setel(Al, i - 1, i - 1, r, active=act)
                    Al = setel(Al, i, i - 1, zero, active=act)
                    Al = rowsk(Al, i - 1, lmat(c, s), lo=i, active=act)
                    Gc = Gc.at[i].set(jnp.where(act, c, Gc[i]))
                    Gs = Gs.at[i].set(jnp.where(act, s, Gs[i]))
                    return Al, Gc, Gs
            else:
                def b_step(t, carry, l=l):
                    Al, Gc, Gs = carry
                    i = n - 1 - t
                    act = i >= j + 2
                    Al = rowsk(Al, i - 1, lmat(Gc[i], Gs[i]), lo=i - 1, active=act)
                    c, s, r = givens(getel(Al, i, i), getel(Al, i, i - 1))
                    Al = setel(Al, i, i, r, active=act)
                    Al = setel(Al, i, i - 1, zero, active=act)
                    Al = colsk(Al, i - 1, lmat(c, s), hi=i, active=act)
                    Gc = Gc.at[i].set(jnp.where(act, c, Gc[i]))
                    Gs = Gs.at[i].set(jnp.where(act, -s, Gs[i]))
                    return Al, Gc, Gs

            Al, Gc, Gs = lax.fori_loop(0, n, b_step, (A[l], Gc, Gs))
            A = A.at[l].set(Al)
            if want_q:
                Q = Q.at[l].set(chain_desc(Q[l], Gc, Gs, j + 2))

        def c_step(t, A0):
            i = n - 1 - t
            act = i >= j + 2
            return colsk(A0, i - 1, rmat_adj(Gc[i], Gs[i]), active=act)

        A = A.at[0].set(lax.fori_loop(0, n, c_step, A[0]))
        return A, Q

    A, Q0 = lax.fori_loop(0, n - 2, col_step, (A, Q0))
    tri = jnp.triu(A[1:], 0) if p > 1 else A[1:]
    H = jnp.concatenate([jnp.triu(A[:1], -1), tri], axis=0)
    return H, Q0
