"""Intra-matrix (row-sharded) operators for the large-N Krylov path.

SURVEY.md §2 names three parallel axes for periodic Schur workloads; this
module implements axis (c), sharding WITHIN the n×n factors, for the one
place it pays off at scale: the operator applications of `partial_pschur`
(the only O(n²)-per-step device work in the Krylov stack — everything else
is O(k²·p) host-side dense work, reference src/krylov.jl:266,327).

Layout: every factor A[l] is sharded by ROW BLOCKS over a 1-D mesh axis;
a matvec keeps the input vector replicated, computes the local
(n/d, n) @ (n,) block product with NO communication, and all-gathers the
(n/d,) partials into the replicated result — one all-gather of n
floats per application, the minimal possible for a dense matvec with
replicated vectors.

Two interfaces:

* ``sharded_dense_ops``: plain per-factor callables (host vector in/out)
  for drop-in use with ``partial_pschur(ops, ...)``.
* ``ShardedCycleOps``: the DEVICE-RESIDENT path (reference's "devarrays"
  branches, src/krylov.jl:239,380-391): the Arnoldi basis lives on the
  mesh and each step runs matvec + iterated-CGS orthogonalization as ONE
  jitted device program — no host round-trip per matvec; only the (k,)
  projection coefficients and norms return to the host.
  ``partial_pschur(ShardedCycleOps(A), ...)`` detects it automatically.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_mesh


def sharded_dense_ops(A, mesh: Optional[Mesh] = None, axis: str = "rows"):
    """Row-shard a stacked (p, n, n) cycle and return matvec callables.

    Args:
      A: (p, n, n) array-like (real or complex); n must be divisible by the
        mesh size.
      mesh: 1-D device mesh (defaults to all devices on one axis ``rows``).

    Returns:
      (ops, n, dtype): ``ops[l]`` maps a replicated (n,) vector to the
      replicated product ``A[l] @ v``; suitable for ``partial_pschur(ops,
      nev, which, n=n, dtype=dtype)``.
    """
    A = jnp.asarray(A)
    p, n, n2 = A.shape
    assert n == n2
    if mesh is None:
        mesh = make_mesh(names=(axis,))
    d = mesh.shape[axis]
    if n % d != 0:
        raise ValueError(f"n={n} not divisible by mesh size {d}")
    row_sharding = NamedSharding(mesh, P(None, axis, None))
    rep = NamedSharding(mesh, P())
    A_sh = jax.device_put(A, row_sharding)

    @jax.jit
    def _mv(Al, v):
        # row-block local matmul; XLA inserts the all-gather of the output
        # rows to satisfy the replicated result sharding
        out = Al @ v
        return jax.lax.with_sharding_constraint(out, rep)

    def make_op(l):
        Al = A_sh[l]

        def op(v):
            v = jax.device_put(jnp.asarray(v), rep)
            return _mv(Al, v)

        return op

    return [make_op(l) for l in range(p)], n, np.dtype(A.dtype)


class ShardedCycleOps:
    """Device-resident row-sharded cycle for ``partial_pschur``.

    Holds the factor stack row-sharded over the mesh and a device-resident
    mirror of the Arnoldi bases; ``apply_orth`` fuses A[l] @ v with the
    iterated-CGS projection (eta-test re-orthogonalization as a traced
    branch) into one jitted program.  The host receives only the
    projection coefficients h and the norms — never the n-vectors —
    except for the one (n,) pull per ACCEPTED column that keeps the
    host-side restart logic's copy of V current.
    """

    def __init__(self, A, mesh: Optional[Mesh] = None, axis: str = "rows"):
        A = jnp.asarray(A)
        p, n, n2 = A.shape
        assert n == n2
        if mesh is None:
            mesh = make_mesh(names=(axis,))
        d = mesh.shape[axis]
        if n % d != 0:
            raise ValueError(f"n={n} not divisible by mesh size {d}")
        self.p, self.n = p, n
        self.dtype = np.dtype(A.dtype)
        self.mesh, self.axis = mesh, axis
        self._rep = NamedSharding(mesh, P())
        self._A = jax.device_put(A, NamedSharding(mesh, P(None, axis, None)))
        self._V = None  # list of (n, width_l) device mirrors

        @jax.jit
        def _step(Al, U, jmask, u, eta):
            """(A @ u) orthogonalized against U's masked columns."""
            v = jax.lax.with_sharding_constraint(Al @ u, self._rep)
            rnorm = jnp.linalg.norm(v)
            h = (U.conj().T @ v) * jmask
            v1 = v - U @ h
            w1 = jnp.linalg.norm(v1)

            def repass(args):
                h, v1, w1 = args
                corr = (U.conj().T @ v1) * jmask
                v2 = v1 - U @ corr
                return h + corr, v2, jnp.linalg.norm(v2)

            h, v2, w2 = jax.lax.cond(w1 < eta * rnorm, repass,
                                     lambda a: a, (h, v1, w1))
            inspan = w2 <= eta * jnp.where(w1 < eta * rnorm, w1, rnorm)
            return h, v2, w2, inspan

        self._step = _step

        @jax.jit
        def _mv_norm(Al, u):
            v = jax.lax.with_sharding_constraint(Al @ u, self._rep)
            return v, jnp.linalg.norm(v)

        self._mv_norm = _mv_norm

    # -- basis mirror management (host PK.V is the source of truth) -------
    def load_basis(self, V):
        """Refresh the device mirrors from the host basis list."""
        self._V = [jax.device_put(jnp.asarray(v), self._rep) for v in V]

    def set_col(self, l, j, col):
        self._V[l] = self._V[l].at[:, j].set(col)

    def get_col(self, l, j):
        return np.asarray(self._V[l][:, j])

    # -- fused device step ------------------------------------------------
    def apply_orth(self, l, lnext, j, ncols, eta):
        """v = A[l] @ V[l][:, j], CGS-orthogonalized against
        V[lnext][:, :ncols].  Returns (h, w, rnorm_flagged, inspan) with
        the normalized vector written into V[lnext][:, ncols_slot] by the
        caller via ``accept``.  ``h`` is masked to ``ncols`` entries."""
        U = self._V[lnext]
        width = U.shape[1]
        jmask = (jnp.arange(width) < ncols).astype(U.dtype)
        u = self._V[l][:, j]
        h, v, w, inspan = self._step(self._A[l], U, jmask, u,
                                     jnp.asarray(eta, jnp.float64))
        self._pending = v
        return np.asarray(h), float(w), bool(inspan)

    def apply_norm(self, l, j):
        """v = A[l] @ V[l][:, j] with no orthogonalization (j == 0 case)."""
        v, w = self._mv_norm(self._A[l], self._V[l][:, j])
        self._pending = v
        return float(w)

    def accept(self, lnext, j, w):
        """Normalize the pending vector into V[lnext][:, j]; returns the
        host copy of the accepted column."""
        col = self._pending / w
        self._V[lnext] = self._V[lnext].at[:, j].set(col)
        return np.asarray(col)
