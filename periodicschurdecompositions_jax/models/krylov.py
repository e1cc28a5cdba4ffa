"""Periodic Krylov-Schur: a few exterior eigenvalues of large cyclic products.

Behavioral contract from the reference's `partial_pschur` (src/krylov.jl, a
Kressner Numer. Math. 2006 scheme): build p coupled orthonormal bases with a
periodic Arnoldi process (one operator application per factor per step,
iterated Gram-Schmidt with the 1/sqrt(2) re-orthogonalization test), solve
the small projected periodic Schur problem with the dense cores, estimate
Ritz residuals by trial reordering per candidate, lock converged wanted
pairs, purge converged unwanted ones, truncate, restore the Hessenberg
structure with a row-wise periodic reduction that preserves the Arnoldi
"foot", and restart.  Left orientation only (like the reference).

Architecture: the restart loop and all O(k^2 p) bookkeeping run host-side
(numpy); the only device-facing work is the operator applications —
``A`` may be a stacked (p, n, n) jax array (dense matvecs run on the
array's device), numpy matrices (host matvecs) or a list of callables
(user-controlled device code, e.g. the factor-ring pipeline in
parallel/ring.py).  The projected problem
uses the jitted dense cores.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from ..types import IllConditionedException, PartialPeriodicSchur, PeriodicSchur, PKSFailure
from ..ops.pqr_real import pqr_real_core
from ..ops.pqz_complex import pqz_complex_core
from .ordschur import ordschur

# default iterated-Gram-Schmidt re-orthogonalization threshold; the live
# value comes from AlgoConfig.eta_orth (reference src/krylov.jl:150)
ETA_ORTH = 1.0 / np.sqrt(2.0)


@dataclasses.dataclass
class ArnoldiHistory:
    """Iteration summary (reference uses ArnoldiMethod.History).

    ``timings`` decomposes the wall-clock into phases (seconds):
    arnoldi (operator applications + iterated CGS — the device programs
    when ops is device-resident), small_schur (host projected dense
    cores), residuals, reorder_writeback (trial reorders + basis
    writeback), verify_locks, total.
    """
    nprods: int
    nconverged: int
    converged: bool
    nev: int
    timings: Optional[dict] = None


# ---------------------------------------------------------------------------
# ordering targets


def _order_key(which: str):
    which = which.upper()
    if which == "LM":
        return lambda lam: -abs(lam)
    if which == "SM":
        return lambda lam: abs(lam)
    if which == "LR":
        return lambda lam: -lam.real
    if which == "SR":
        return lambda lam: lam.real
    if which == "LI":
        return lambda lam: -lam.imag
    if which == "SI":
        return lambda lam: lam.imag
    raise ValueError(f"unknown target {which!r}; use LM/SM/LR/SR/LI/SI")


# ---------------------------------------------------------------------------
# operators


def _as_ops(A, n=None, dtype=None):
    if hasattr(A, "apply_orth"):
        # device-resident sharded cycle (parallel.krylov_ops.ShardedCycleOps)
        return A, A.p, A.n, np.dtype(A.dtype)
    if hasattr(A, "devices") and hasattr(A, "ndim"):
        # stacked jax array: the matvecs run where the factors live
        p, n = A.shape[0], A.shape[1]
        return ([lambda x, a=A[l]: a @ x for l in range(p)], p, n,
                np.dtype(A.dtype))
    if hasattr(A, "ndim") or isinstance(A, (list, tuple)) and hasattr(A[0], "ndim"):
        An = [np.asarray(a) for a in A]
        n = An[0].shape[0]
        dtype = An[0].dtype
        return [lambda x, a=a: a @ x for a in An], len(An), n, np.dtype(dtype)
    if not (isinstance(A, (list, tuple)) and callable(A[0])):
        raise TypeError("A must be a (p, n, n) stack, list of matrices, or "
                        "list of callables")
    if n is None or dtype is None:
        raise ValueError("matrix-free operators need n= and dtype= arguments")
    return list(A), len(A), int(n), np.dtype(dtype)


# ---------------------------------------------------------------------------
# periodic Arnoldi (reference src/krylov.jl:228-414)


class _PKrylov:
    def __init__(self, p, n, kmax, dtype, rng, vrand=None):
        self.p, self.n, self.kmax = p, n, kmax
        self.V = [np.zeros((n, kmax + 1), dtype)] + \
            [np.zeros((n, kmax), dtype) for _ in range(p - 1)]
        self.B = [np.zeros((kmax, kmax), dtype) for _ in range(p - 1)] + \
            [np.zeros((kmax + 1, kmax), dtype)]
        self.k = 0
        self.rng = rng
        self.dtype = np.dtype(dtype)
        self._vrand = vrand

    def vrand(self, shape):
        """Restart-vector filler; user-injectable like the reference's
        ``vrand!`` keyword (src/krylov.jl:454)."""
        if self._vrand is not None:
            return np.asarray(self._vrand(shape), dtype=self.dtype)
        v = self.rng.standard_normal(shape)
        if np.issubdtype(self.dtype, np.complexfloating):
            v = v + 1j * self.rng.standard_normal(shape)
        return v.astype(self.dtype)


def _reinitialize(PK: _PKrylov, l: int, j: int,
                  eta: float = ETA_ORTH) -> bool:
    """Random re-start of basis column j of slot l, orthogonalized
    (reference :152-181)."""
    from ..config import verbosity as _verby
    if _verby("krylov") >= 1:
        print(f"[krylov] breakdown: reinitializing basis column {j} "
              f"of slot {l} with a random vector", flush=True)
    v = PK.vrand(PK.n)
    rnorm = np.linalg.norm(v)
    if j > 0:
        U = PK.V[l][:, :j]
        h = U.conj().T @ v
        v = v - U @ h
        w = np.linalg.norm(v)
        if w < eta * rnorm:
            rnorm = w
            h = U.conj().T @ v
            v = v - U @ h
            w = np.linalg.norm(v)
        if w <= eta * rnorm:
            return False
        v = v / w
    else:
        v = v / rnorm
    PK.V[l][:, j] = v
    return True


def _orth_step(U, v, eta: float = ETA_ORTH):
    """One iterated-CGS orthogonalization; returns (h, v, wnorm, in_span)."""
    rnorm = np.linalg.norm(v)
    h = U.conj().T @ v
    v = v - U @ h
    w = np.linalg.norm(v)
    if w < eta * rnorm:
        rnorm = w
        corr = U.conj().T @ v
        v = v - U @ corr
        h = h + corr
        w = np.linalg.norm(v)
    return h, v, w, w <= eta * rnorm


def periodic_arnoldi(ops, PK: _PKrylov, k1: int, k2: int, u: np.ndarray,
                     tol1: float, eta: float = ETA_ORTH) -> bool:
    """Extend the periodic Krylov decomposition to columns [k1, k2).

    0-based: fills columns k1..k2-1.  Returns False after too many
    singularity repairs (reference's 5-strike budget, :396-407).
    """
    p, n = PK.p, PK.n
    devops = hasattr(ops, "apply_orth")
    PK.V[0][:, k1] = u
    if devops:
        # device-resident path (parallel.krylov_ops.ShardedCycleOps): the
        # basis lives on the mesh; each step is one jitted matvec+CGS with
        # no host round-trip (only h and norms come back).  Host PK.V stays
        # the source of truth for the restart logic: accepted columns are
        # pulled once, and any host-side repair reloads the mirror.
        ops.load_basis(PK.V)
    j = k1
    singularities = 0
    while j < k2:
        ldef, jdef = -1, -1
        null1 = False
        for l in range(p - 1):
            if j > 0:
                if devops:
                    h, w, inspan = ops.apply_orth(l, l + 1, j, j, eta)
                    PK.B[l][:j, j] = h[:j]
                else:
                    v = np.asarray(ops[l](PK.V[l][:, j]))
                    h, v, w, inspan = _orth_step(PK.V[l + 1][:, :j], v, eta)
                    PK.B[l][:j, j] = h
            else:
                if devops:
                    w = ops.apply_norm(l, j)
                else:
                    v = np.asarray(ops[l](PK.V[l][:, j]))
                    w = np.linalg.norm(v)
                inspan = False
                if w < tol1:
                    null1 = True
                    break
            if inspan:
                if ldef < 0:
                    ldef, jdef = l, j
                PK.B[l][j, j] = 0.0
                if not _reinitialize(PK, l + 1, j, eta):
                    raise PKSFailure("Arnoldi reinitialization failed")
                if devops:
                    ops.load_basis(PK.V)
            else:
                PK.B[l][j, j] = w
                if devops:
                    PK.V[l + 1][:, j] = ops.accept(l + 1, j, w)
                else:
                    PK.V[l + 1][:, j] = v / w
        if null1:
            # the reference's 5-strike singularity budget applies here too:
            # an operator whose image of EVERY restart vector stays below
            # tol1 must fail instead of retrying forever
            singularities += 1
            if singularities > 5:
                return False
            if not _reinitialize(PK, 0, 0, eta):
                raise PKSFailure("Arnoldi reinitialization failed")
            if devops:
                ops.load_basis(PK.V)
            continue

        if devops:
            h, w, inspan = ops.apply_orth(p - 1, 0, j, j + 1, eta)
            PK.B[p - 1][:j + 1, j] = h[:j + 1]
        else:
            v = np.asarray(ops[p - 1](PK.V[p - 1][:, j]))
            h, v, w, inspan = _orth_step(PK.V[0][:, :j + 1], v, eta)
            PK.B[p - 1][:j + 1, j] = h
        if inspan:
            PK.B[p - 1][j + 1, j] = 0.0
            # restart the next column randomly; when an in-cycle
            # deflation is also pending (ldef >= 0) the column STILL needs
            # fresh data — leaving it unset fed stale/zero basis vectors
            # into the next step
            if not _reinitialize(PK, 0, j + 1, eta):
                if j + 1 >= n and j == k2 - 1:
                    # complete-basis lucky breakdown: V[0] spans the whole
                    # space (maxdim == n requested), so the decomposition
                    # closes EXACTLY with a zero foot entry and the ghost
                    # head column stays zero (its every use multiplies the
                    # zero foot).  The reference throws PKSFailure here
                    # (src/krylov.jl:362 -> :181), but a full-space request
                    # is legitimate and must terminate with the complete
                    # decomposition instead.
                    PK.k = j + 1
                    return True
                raise PKSFailure("Arnoldi reinitialization failed")
            if devops:
                ops.load_basis(PK.V)
        else:
            PK.B[p - 1][j + 1, j] = w
            if devops:
                PK.V[0][:, j + 1] = ops.accept(0, j + 1, w)
            else:
                PK.V[0][:, j + 1] = v / w

        if ldef >= 0:
            # exact deflation inside the cycle: rotate the zero out
            _deflate_krylov(PK, ldef, jdef)
            hn = np.linalg.norm(PK.B[p - 1][:jdef + 1, :jdef + 1])
            if abs(PK.B[p - 1][jdef + 1, jdef]) >= 100 * np.finfo(
                    PK.V[0].real.dtype).eps * max(hn, 1e-300):
                singularities += 1
                if singularities > 5:
                    return False
                if jdef + 1 < k2:
                    if not _reinitialize(PK, 0, jdef + 1, eta):
                        raise PKSFailure("Arnoldi reinitialization failed")
            if devops:
                ops.load_basis(PK.V)
        PK.k = j + 1
        j += 1
    return True


def _deflate_krylov(PK: _PKrylov, ldef: int, jdef: int):
    """Unshifted half-sweep pushing an in-cycle zero to the foot
    (reference `_deflate!`, src/krylov.jl:184-226)."""
    from ..ops.reorder_np import _givens_np, _gmat
    p = PK.p
    nwid = jdef + 1
    Bp = PK.B[p - 1]
    G = []
    for j in range(jdef):
        c, s, _ = _givens_np(Bp[j, j], Bp[j + 1, j])
        M = _gmat(c, s)
        Bp[j:j + 2, :] = M @ Bp[j:j + 2, :]
        Bp[j + 1, j] = 0.0
        G.append(M)
    Z = [np.eye(nwid, dtype=PK.dtype) for _ in range(p)]
    for j in range(jdef):
        Z[0][:, j:j + 2] = Z[0][:, j:j + 2] @ G[j].conj().T
    for l in range(p - 1):
        Bl = PK.B[l]
        for j in range(jdef):
            Bl[:, j:j + 2] = Bl[:, j:j + 2] @ G[j].conj().T
            c, s, _ = _givens_np(Bl[j, j], Bl[j + 1, j])
            M = _gmat(c, s)
            Bl[j:j + 2, :] = M @ Bl[j:j + 2, :]
            Bl[j + 1, j] = 0.0
            G[j] = M
        for j in range(jdef):
            Z[l + 1][:, j:j + 2] = Z[l + 1][:, j:j + 2] @ G[j].conj().T
    for j in range(jdef - 1):
        Bp[:, j:j + 2] = Bp[:, j:j + 2] @ G[j].conj().T
    for l in range(p):
        w = PK.V[l][:, :nwid] @ Z[l][:nwid, :nwid]
        PK.V[l][:, :nwid] = w


# ---------------------------------------------------------------------------
# row-wise periodic Hessenberg restoration (reference src/rhessx.jl)


def _unitary_row_annihilator(u):
    """Hermitian unitary R with R @ u = phase * |u| * e_last."""
    m = len(u)
    nu = np.linalg.norm(u)
    if nu == 0:
        return np.eye(m, dtype=u.dtype)
    phase = u[-1] / abs(u[-1]) if u[-1] != 0 else 1.0
    t = np.zeros(m, dtype=complex if np.iscomplexobj(u) else float)
    t[-1] = phase * nu
    w = u - t
    wn = np.vdot(w, w).real
    if wn < np.finfo(float).tiny:
        return np.eye(m, dtype=u.dtype)
    return (np.eye(m) - 2.0 * np.outer(w, np.conj(w)) / wn).astype(u.dtype)


def _restore_hessenberg(PK: _PKrylov, active: int, k: int):
    """Row-wise left-oriented periodic Hessenberg reduction on the window
    [active, k) that preserves the Arnoldi foot (reference `_rphessenberg!`
    semantics: row reflectors annihilate LEADING entries)."""
    p = PK.p
    a = active
    Bp = PK.B[p - 1]
    nwrk = k - a
    Q = [np.eye(nwrk, dtype=PK.dtype) for _ in range(p)]

    def apply_w(slot, hi, W):
        """W acts on window-columns [0, hi) of the slot's B and the rows of
        the previous slot's B; accumulate into Q[slot]."""
        prev = (slot - 1) % p
        Bs = PK.B[slot]
        Bs[:, a:a + hi] = Bs[:, a:a + hi] @ W
        Bprev = PK.B[prev]
        Bprev[a:a + hi, :] = W.conj().T @ Bprev[a:a + hi, :]
        Q[slot][:, :hi] = Q[slot][:, :hi] @ W

    # foot row of the Hessenberg slot (if the window touches it)
    if k == PK.k:
        u = np.conj(Bp[k, a:k])
        W = _unitary_row_annihilator(u)
        apply_w(p - 1, nwrk, W)
        Bp[k, a:k - 1] = 0.0
    for i in range(nwrk - 1, 0, -1):
        # triangularize rows i of the triangular slots
        for l in range(p - 2, -1, -1):
            u = np.conj(PK.B[l][a + i, a:a + i + 1])
            W = _unitary_row_annihilator(u)
            apply_w(l, i + 1, W)
            PK.B[l][a + i, a:a + i] = 0.0
        u = np.conj(Bp[a + i, a:a + i])
        W = _unitary_row_annihilator(u)
        apply_w(p - 1, i, W)
        Bp[a + i, a:a + i - 1] = 0.0
    # apply accumulated Q to the bases; the locked coupling rows were
    # already transformed inside apply_w (its column updates span ALL rows
    # of B) — a second application here double-transformed them and broke
    # the Krylov relations on the first restart after any lock
    for l in range(p):
        PK.V[l][:, a:k] = PK.V[l][:, a:k] @ Q[l]


# ---------------------------------------------------------------------------
# driver


def _small_pschur(B: List[np.ndarray], active: int, kmax: int, dtype):
    """Dense periodic Schur of the projected window (right-ordered stack)."""
    p = len(B)
    sub = slice(active, kmax)
    mats = [np.triu(B[p - 1][sub, sub], -1)] + \
        [np.triu(B[l][sub, sub]) for l in range(p - 2, -1, -1)]
    # HOST-side dense solve of the small projected cycle, pinned to the CPU
    # device: it is sequential work on a window whose size changes as
    # locks accumulate, so each new size would cost a device compile and
    # many tiny launches for milliseconds of arithmetic.
    import jax as _jax

    # NATIVE-first: the jitted exact cores compile once per distinct window
    # size, and a restart run meets many sizes; the C++ window solves need
    # no compile.
    from .. import native as _native
    Hnp = np.stack(mats)
    if _native.available():
        with _jax.default_device(_jax.devices("cpu")[0]):
            if np.issubdtype(dtype, np.complexfloating):
                out = _native.pqz_complex_cpu(
                    Hnp.astype(np.complex128), (True,) * p)
                if out is not None:
                    T, Z, al, be, sc = out
                    values = al / np.where(be == 0, 1.0, be) * np.exp2(
                        sc.astype(float))
                    values = np.where(be == 0, np.inf, values)
                    return PeriodicSchur(Ts=jnp.asarray(T),
                                         Zs=jnp.asarray(Z),
                                         values=jnp.asarray(values),
                                         orientation="R", schurindex=0)
            else:
                try:
                    T, Z, wr, wi = _native.pschur_real_cpu(Hnp)
                    return PeriodicSchur(
                        Ts=jnp.asarray(T), Zs=jnp.asarray(Z),
                        values=jnp.asarray(wr + 1j * wi),
                        orientation="R", schurindex=0)
                except RuntimeError:
                    pass  # non-convergence: the jitted core may still land

    with _jax.default_device(_jax.devices("cpu")[0]):
        H = jnp.asarray(Hnp)
        if np.issubdtype(dtype, np.complexfloating):
            T, Z, al, be, sc, ok = pqz_complex_core(H, (True,) * p)
            values = np.asarray(al) / np.asarray(be) * np.exp2(
                np.asarray(sc).astype(float))
        else:
            T, Z, wr, wi, ok = pqr_real_core(H)
            values = np.asarray(wr) + 1j * np.asarray(wi)
        if not bool(ok):
            raise PKSFailure("projected periodic Schur failed to converge")
        return PeriodicSchur(Ts=jnp.asarray(np.asarray(T)),
                             Zs=jnp.asarray(np.asarray(Z)),
                             values=jnp.asarray(values),
                             orientation="R", schurindex=0)


def _slot_q(PS: PeriodicSchur) -> List[np.ndarray]:
    """Map the small right-oriented Z stack onto Krylov basis slots:
    Q[l] = W[(p - l) % p] (see module docstring derivation)."""
    p = PS.period
    W = np.asarray(PS.Zs)
    return [W[(p - l) % p] for l in range(p)]


def _blocks_of(T0: np.ndarray) -> List[tuple]:
    """(start, size) diagonal-block partition from the quasi-triangular
    factor's subdiagonal (1x1 everywhere for complex/strict-triangular)."""
    k = T0.shape[0]
    blocks = []
    i = 0
    while i < k:
        if i + 1 < k and T0[i + 1, i] != 0:
            blocks.append((i, 2))
            i += 2
        else:
            blocks.append((i, 1))
            i += 1
    return blocks


def _invariant_basis_at1(Ts: np.ndarray, bstart: int, bsize: int,
                         blocks: List[tuple]) -> np.ndarray:
    """Orthonormal basis of the T-cycle invariant subspace at slot 1.

    ``Ts``: (p, k, k) right-oriented (quasi-)triangular stack with
    ``Zs[l]^H M[l] Zs[l+1] = Ts[l]``; the diagonal block at ``bstart`` (size
    ``bsize``) names the candidate.  The basis columns v satisfy
    ``(Ts[1] Ts[2] ... Ts[0]) v = v Mprod`` with the block's eigenvalues —
    i.e. exactly the span the leading columns of a reordered Zs[1] acquire,
    but obtained by cyclic periodic-Sylvester back-substitution (the math of
    models/vectors.py's pair solve) instead of a trial ``ordschur``.

    Raises IllConditionedException (from pgsylsolve) when a level's
    separation vanishes; callers fall back to the trial-reorder probe.
    """
    from ..ops.reorder_np import pgsylsolve
    p, kk, _ = Ts.shape
    dt = Ts.dtype
    M = [Ts[l, bstart:bstart + bsize, bstart:bstart + bsize]
         for l in range(p)]
    above = [b for b in blocks if b[0] < bstart]
    Sd = (True,) * p
    # fill[l][bi] = X_l block for level bi; level equations (derived from
    # Ts[l] v_{l+1} = v_l M_l on v = [x; I; 0]):
    #   Ts[l][Bi,Bi] X_{l+1} - X_l M_l = -C_l,
    # solved nearest-level-first so C can accumulate the in-between fill.
    fill = [dict() for _ in range(p)]
    for bi, bs in reversed(above):
        A = [Ts[l, bi:bi + bs, bi:bi + bs] for l in range(p)]
        C = []
        for l in range(p):
            ln = (l + 1) % p
            c = np.array(Ts[l, bi:bi + bs, bstart:bstart + bsize],
                         dtype=dt)
            for bq, bqs in above:
                if bq > bi:
                    c = c + Ts[l, bi:bi + bs, bq:bq + bqs] @ fill[ln][bq]
            C.append(c)
        # map A_l X_{l+1} - X_l B_l = -C_l onto pgsylsolve's
        # A'[k] X'[k] - X'[k+1] B'[k] = -C'[k] by reversing the cycle
        # (X'[k] = X_{(1-k) % p}; verified numerically in the tests)
        Ar = [A[(-k) % p] for k in range(p)]
        Br = [M[(-k) % p] for k in range(p)]
        Cr = [C[(-k) % p] for k in range(p)]
        v = pgsylsolve(Ar, Br, Cr, Sd)
        pp = bs * bsize
        for k2 in range(p):
            fill[(1 - k2) % p][bi] = \
                v[k2 * pp:(k2 + 1) * pp].reshape((bs, bsize), order="F")
    V = np.zeros((kk, bsize), dtype=dt)
    V[bstart:bstart + bsize] = np.eye(bsize, dtype=dt)
    for bi, bs in above:
        V[bi:bi + bs] = fill[1 % p][bi]
    if not np.all(np.isfinite(V)):
        raise IllConditionedException()
    q, _ = np.linalg.qr(V)
    return q


def _residuals(PS, foot, ritz_ord, lams, isreal_t):
    """Ritz residuals per candidate (reference `_compute_ritz_resids!`,
    src/krylov.jl:833-919).

    Fast path: the residual only needs the span the leading columns of
    Zs[1] would acquire after reordering the candidate to the top, so it is
    computed DIRECTLY from a cyclic Sylvester back-substitution
    (:func:`_invariant_basis_at1`) — O(k^2 p) per candidate instead of the
    reference's full trial ``ordschur`` (O(k^3 p) swap machinery plus a
    decomposition copy per candidate, the dominant host cost at larger
    maxdim).  Values are identical for 1x1 candidates (the same unit
    vector up to phase); for pairs the projection 2-norm replaces the
    basis-dependent max-|entry| of the trial probe (within sqrt(2),
    conservative).  Ill-conditioned levels fall back to the trial probe.
    """
    nwrk = len(lams)
    Tsn = np.asarray(PS.Ts)
    W1 = np.asarray(PS.Zs)[1 % PS.period]
    blocks = _blocks_of(Tsn[0])
    rs = np.full(nwrk, np.inf)
    skip_next = False
    for idx, j in enumerate(ritz_ord):
        if skip_next:
            skip_next = False
            continue
        lam = lams[j]
        pair = isreal_t and lam.imag != 0
        jc = None
        if pair:
            jc = j + 1 if j + 1 < nwrk and abs(np.conj(lams[j + 1]) - lam) <= \
                1e-8 * max(abs(lam), 1e-300) else j - 1
            skip_next = True
        bstart, bsize = (min(j, jc), 2) if pair else (j, 1)
        # the candidate must align with the quasi-triangular block
        # partition (a half-pair or straddled block falls back to the
        # trial probe, which handles any structure)
        aligned = (bstart, bsize) in blocks if pair else \
            any(b == (bstart, 1) for b in blocks)
        try:
            if not aligned:
                raise IllConditionedException()
            U = _invariant_basis_at1(Tsn, bstart, bsize, blocks)
            newrow = foot @ (W1 @ U)
            r = float(np.linalg.norm(newrow))
        except (IllConditionedException, np.linalg.LinAlgError):
            r = _residual_trial(PS, foot, j, jc, nwrk)
        if pair:
            rs[j] = r
            rs[jc] = r
        else:
            rs[j] = r
    return rs


def _residual_trial(PS, foot, j, jc, nwrk):
    """Trial-reorder residual probe for one candidate (the reference's
    scheme, src/krylov.jl:833-919): move it to the top, read the
    transformed foot row."""
    select = np.zeros(nwrk, bool)
    select[j] = True
    if jc is not None:
        select[jc] = True
    try:
        PSx = ordschur(PS, list(select))
    except IllConditionedException:
        return float(np.abs(foot[:j + 1]).max())
    Q = _slot_q(PSx)
    newrow = foot @ Q[p_of(PSx)]
    if jc is not None:
        return float(max(abs(newrow[0]), abs(newrow[1])))
    return float(abs(newrow[0]))


def p_of(PS):
    return PS.period - 1


def partial_pschur(
    A,
    nev: int = 6,
    which: str = "LM",
    *,
    n: Optional[int] = None,
    dtype=None,
    mindim: Optional[int] = None,
    maxdim: Optional[int] = None,
    tol: Optional[float] = None,
    restarts: int = 100,
    purgebuffer: int = 2,
    u1: Optional[np.ndarray] = None,
    seed: int = 1234,
    eta_orth: Optional[float] = None,
    vrand=None,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = True,
):
    """Find ``nev`` exterior eigenvalues of the product ``A[p-1] @ ... @ A[0]``
    (left orientation, like the reference) by periodic Krylov-Schur.

    Args:
      A: (p, n, n) stack / list of matrices / list of matvec callables
         (callables need ``n=`` and ``dtype=``).
      which: LM, SM, LR, SR, LI or SI.
      tol: convergence tolerance (default sqrt(eps)).
      eta_orth: iterated-Gram-Schmidt re-orthogonalization threshold
        (default: AlgoConfig.eta_orth = 1/sqrt(2), reference src/krylov.jl:150).
      vrand: optional ``vrand(shape) -> ndarray`` filler for restart vectors
        (reference's custom ``vrand!``, src/krylov.jl:454); reproducible
        structured restarts.  Defaults to a seeded Gaussian.
      checkpoint: optional path; the restart loop state (bases, projected
        factors, Ritz bookkeeping, RNG) is saved there every
        ``checkpoint_every`` restarts, and — when ``resume`` — a matching
        existing file continues the loop mid-run.  Beyond the reference
        (SURVEY.md §5: no checkpointing exists there); long restart runs
        on expensive operators survive interruption.

    Returns:
      (PartialPeriodicSchur, ArnoldiHistory)
    """
    ops, p, n, dtype = _as_ops(A, n=n, dtype=dtype)
    isreal_t = not np.issubdtype(dtype, np.complexfloating)
    eps = float(np.finfo(dtype).eps)
    if tol is None:
        tol = float(np.sqrt(eps))
    if nev < 1:
        raise ValueError("nev must be >= 1")
    if mindim is None:
        mindim = min(max(10, nev), n)
    if maxdim is None:
        maxdim = min(max(20, 2 * nev), n)
    if not (nev <= mindim <= maxdim <= n):
        raise ValueError(f"need nev <= mindim <= maxdim <= n, got "
                         f"{nev} <= {mindim} <= {maxdim} <= {n}")
    if eta_orth is None:
        from ..config import default_config
        eta_orth = float(default_config.eta_orth)
    rng = np.random.default_rng(seed)
    import time as _time
    _tm = {"arnoldi": 0.0, "small_schur": 0.0, "residuals": 0.0,
           "reorder_writeback": 0.0, "verify_locks": 0.0, "total": 0.0}
    _t00 = _time.perf_counter()
    PK = _PKrylov(p, n, maxdim, dtype, rng, vrand=vrand)
    key0 = _order_key(which)
    if isreal_t:
        # real spectra come in conjugate pairs stored adjacently; an
        # imag-signed key (LI/SI) would sort the partners to opposite
        # ends and break every pair-adjacency assumption downstream
        def key(lam):
            return key0(lam if lam.imag >= 0 else np.conj(lam))
    else:
        key = key0
    eps23 = eps ** (2.0 / 3.0)

    tol1 = 100 * eps
    start_it = 0
    resumed = False
    if checkpoint is not None and resume:
        import os as _os
        if _os.path.exists(checkpoint):
            from ..utils.io import load_krylov_state
            Vc, Bc, meta = load_krylov_state(checkpoint)
            if (int(meta["p"]) != p or int(meta["n"]) != n or
                    int(meta["maxdim"]) != maxdim or
                    str(meta["dtype"]) != np.dtype(dtype).name):
                raise ValueError(
                    "checkpoint problem shape/dtype mismatch: "
                    f"{dict(p=int(meta['p']), n=int(meta['n']), maxdim=int(meta['maxdim']), dtype=str(meta['dtype']))}")
            for l in range(p):
                PK.V[l][...] = Vc[l]
                PK.B[l][...] = Bc[l]
            PK.k = int(meta["k"])
            import ast as _ast
            rng.bit_generator.state = _ast.literal_eval(str(meta["rng"]))
            nprods = int(meta["nprods"])
            nlock = int(meta["nlock"])
            active = int(meta["active"])
            k = int(meta["k"])
            lams_all = np.asarray(meta["lams_all"], complex).copy()
            rs_all = np.asarray(meta["rs_all"], float).copy()
            start_it = int(meta["it"]) + 1
            pa_ok = True
            resumed = True

    if not resumed:
        if u1 is None:
            v = PK.vrand(n)
        else:
            v = np.asarray(u1, dtype=dtype)
        v = v / np.linalg.norm(v)
        _t0 = _time.perf_counter()
        pa_ok = periodic_arnoldi(ops, PK, 0, mindim, v, tol1, eta_orth)
        _tm["arnoldi"] += _time.perf_counter() - _t0
        nprods = p * mindim
        if not pa_ok:
            # singularity budget exhausted during the initial build: the
            # basis beyond the failure point was never constructed
            restarts = 0
        nlock = 0
        active = 0
        k = mindim
        lams_all = np.zeros(maxdim, complex)
        rs_all = np.full(maxdim, np.inf)

    for it in range(start_it, restarts):
        if it > 0:
            _restore_hessenberg(PK, active, k)
        u = PK.V[0][:, k]
        _t0 = _time.perf_counter()
        pa_ok = periodic_arnoldi(ops, PK, k, maxdim, u, tol1, eta_orth)
        _tm["arnoldi"] += _time.perf_counter() - _t0
        nprods += p * (maxdim - k)

        _t0 = _time.perf_counter()
        PS = _small_pschur(PK.B, active, maxdim, dtype)
        _tm["small_schur"] += _time.perf_counter() - _t0
        Hnorm = np.linalg.norm(np.asarray(PS.T1))
        foot = PK.B[p - 1][maxdim, active:maxdim].copy()
        lams = np.asarray(PS.values)
        lams_all[active:maxdim] = lams
        nwrk = maxdim - active

        def conv(lam, r):
            return r < max(eps23 * Hnorm, tol * abs(lam))

        # order all current estimates by preference
        order = sorted(range(maxdim), key=lambda j: key(lams_all[j]))
        # effective nev: widen across a conjugate pair boundary
        eff_nev = nev
        if isreal_t and eff_nev < maxdim:
            lj = lams_all[order[eff_nev - 1]]
            ln = lams_all[order[eff_nev]]
            if lj.imag != 0 and abs(np.conj(lj) - ln) <= 1e-8 * max(
                    abs(lj), 1e-300):
                eff_nev += 1

        _t0 = _time.perf_counter()
        rs = _residuals(PS, foot, list(range(nwrk)),
                        lams, isreal_t)
        _tm["residuals"] += _time.perf_counter() - _t0
        rs_all[active:maxdim] = rs

        # locking: leading wanted candidates that have converged
        nlock = 0
        for i in range(eff_nev):
            j = order[i]
            if conv(lams_all[j], rs_all[j]):
                nlock += 1
            else:
                break

        _t0 = _time.perf_counter()
        # move locked-but-active candidates to the top of the window
        if nlock > active:
            select = np.zeros(nwrk, bool)
            for i in range(nlock):
                j = order[i]
                if active <= j < maxdim:
                    select[j - active] = True
            # block-align: ordschur silently widens a half-selected 2x2
            # pair, so the perm bookkeeping must see the SAME widened
            # select or lams_all/rs_all desynchronize from the columns
            nlock += _widen_pairs(select, np.asarray(PS.Ts)[0])
            if select.any():
                try:
                    PS = ordschur(PS, list(select))
                except IllConditionedException:
                    # the move failed: nothing is at the top; claim no new
                    # locks this restart (verify_locks re-checks anyway)
                    nlock = active
                else:
                    perm = _perm_from_select(select)
                    lams_all[active:maxdim] = lams_all[active:maxdim][perm]
                    rs_all[active:maxdim] = rs_all[active:maxdim][perm]

        # truncation length (conjugate-pair safe)
        k = min(nlock + mindim, (mindim + maxdim) // 2)
        k = max(k, nlock + 1)
        if isreal_t and k < maxdim:
            lk = lams_all[k - 1]
            if lk.imag != 0 and abs(np.conj(lk) - lams_all[k]) <= \
                    1e-8 * max(abs(lk), 1e-300):
                k += 1
        k = min(k, maxdim - 1)

        # retain the k preferred candidates (re-sorted after locking moves)
        order2 = sorted(range(maxdim), key=lambda j: key(lams_all[j]))
        # purge: converged-but-unwanted Ritz pairs have no reason to appear
        # in preference order, so stably push them past the retention cut —
        # truncation then drops them instead of letting them squat in the
        # subspace (reference src/krylov.jl:674-683; ``purgebuffer`` keeps a
        # few partially-converged hopefuls above the cut)
        if nlock < nev:
            istart = nlock + purgebuffer
            tail = order2[istart:]
            tail.sort(key=lambda j: 1 if conv(lams_all[j], rs_all[j]) else 0)
            order2 = order2[:istart] + tail
        select = np.zeros(nwrk, bool)
        nsel = 0
        for i in range(maxdim):
            j = order2[i]
            if active <= j < maxdim and nsel < k - active:
                select[j - active] = True
                nsel += 1
        # block-align the retention select (see the locking move): a
        # preference cut through a 2x2 block would discard its O(1)
        # subdiagonal and desynchronize the perm bookkeeping
        k += _widen_pairs(select, np.asarray(PS.Ts)[0])
        if k > maxdim - 1:
            # widening overflowed the window: drop the straddling pair
            T0w = np.asarray(PS.Ts)[0]
            for i in range(nwrk - 2, -1, -1):
                if select[i] and T0w[i + 1, i] != 0 and select[i + 1]:
                    select[i] = select[i + 1] = False
                    k -= 2
                    break
        try:
            PS2 = ordschur(PS, list(select))
            perm = _perm_from_select(select)
            lams_all[active:maxdim] = lams_all[active:maxdim][perm]
            rs_all[active:maxdim] = rs_all[active:maxdim][perm]
            PS = PS2
        except IllConditionedException:
            pass

        # write the small solution back into the Krylov decomposition
        Q = _slot_q(PS)
        Ts = np.asarray(PS.Ts)
        Bp = PK.B[p - 1]
        Bp[active:maxdim, active:maxdim] = Ts[0]
        Bp[maxdim, active:maxdim] = foot @ Q[p - 1]
        for l in range(p - 1):
            # right-ordered stack index of factor-l window: p-1-l
            PK.B[l][active:maxdim, active:maxdim] = Ts[(p - 1 - l) % p]
        for l in range(p):
            PK.V[l][:, active:maxdim] = PK.V[l][:, active:maxdim] @ Q[l]
            if active > 0:
                PK.B[l][:active, active:maxdim] = \
                    PK.B[l][:active, active:maxdim] @ Q[l]

        # truncate
        PK.V[0][:, k] = PK.V[0][:, maxdim]
        Bp[k, :k] = Bp[maxdim, :k]
        Bp[k + 1:, :] = 0.0
        for l in range(p - 1):
            PK.B[l][k:, :] = 0.0
        PK.k = k
        _tm["reorder_writeback"] += _time.perf_counter() - _t0

        # verify locks against the actual foot (reference `_verify_locks!`)
        _t0 = _time.perf_counter()
        nlock = _verify_locks(PK, lams_all, rs_all, nlock, conv, isreal_t)
        _tm["verify_locks"] += _time.perf_counter() - _t0
        active = nlock
        # restart tracing on the ``krylov`` channel (the reference prints
        # per-restart lock/residual progress via _kry_verby,
        # src/diagnostics.jl:5-31 + src/krylov.jl verbosity hooks)
        from ..config import verbosity as _verby
        if _verby("krylov") >= 1:
            best = np.sort(rs_all[:maxdim])[:max(nev, 1)]
            print(f"[krylov] restart {it + 1}: locked {active}/{nev} "
                  f"k={k} nprods={nprods} best resid "
                  + np.array2string(best, precision=2), flush=True)
        if not pa_ok:
            # singularity budget exhausted while extending: keep the locks
            # verified THIS restart (an exactly-deflating rank-deficient
            # operator ends here with its converged eigenvalues in hand)
            break
        if checkpoint is not None and (it + 1) % max(checkpoint_every, 1) == 0:
            from ..utils.io import save_krylov_state
            save_krylov_state(checkpoint, PK.V, PK.B, {
                "p": p, "n": n, "maxdim": maxdim,
                "dtype": np.dtype(dtype).name,
                "rng": str(rng.bit_generator.state),
                "nprods": nprods, "nlock": nlock, "active": active,
                "k": k, "it": it,
                "lams_all": lams_all, "rs_all": rs_all})
        if active >= nev:
            break

    nconv = active
    Vc = np.stack([PK.V[l][:, :nconv] for l in range(p)])
    Tc = np.stack([np.triu(PK.B[l][:nconv, :nconv],
                           -1 if l == p - 1 else 0) for l in range(p)])
    # stacked factor order: slot l holds B[l]; Schur factor is slot p-1.
    ps = PartialPeriodicSchur(
        Ts=jnp.asarray(Tc),
        Vs=jnp.asarray(Vc),
        values=jnp.asarray(lams_all[:nconv]),
        residuals=jnp.asarray(rs_all[:nconv]),
        orientation="L", schurindex=p - 1)
    _tm["total"] = _time.perf_counter() - _t00
    hist = ArnoldiHistory(nprods=nprods, nconverged=nconv,
                          converged=nconv >= nev, nev=nev,
                          timings={k_: round(v_, 4)
                                   for k_, v_ in _tm.items()})
    return ps, hist


def _perm_from_select(select):
    sel = [i for i, s in enumerate(select) if s]
    uns = [i for i, s in enumerate(select) if not s]
    return np.array(sel + uns)


def _widen_pairs(select, T0w):
    """Widen a selection over the quasi factor's 2x2 blocks IN PLACE.

    ``ordschur`` silently widens a half-selected conjugate pair; every
    caller that permutes its own bookkeeping with ``_perm_from_select``
    must therefore widen the select identically first.  Returns the
    number of entries added.
    """
    added = 0
    i = 0
    m = len(select)
    while i < m - 1:
        if T0w[i + 1, i] != 0:
            if bool(select[i]) != bool(select[i + 1]):
                select[i] = select[i + 1] = True
                added += 1
            i += 2
        else:
            i += 1
    return added


def _verify_locks(PK, lams, rs, nlock, conv, isreal_t):
    p = PK.p
    k = PK.k
    Bp = PK.B[p - 1]
    i = 0
    ncv = 0
    while i < nlock:
        lam = lams[i]
        if isreal_t and lam.imag != 0:
            r = np.hypot(abs(Bp[k, i]), abs(Bp[k, i + 1]) if i + 1 <= k else 0.0)
            rs[i] = rs[i + 1] = r
            if not conv(lam, r):
                break
            ncv = i + 2
            i += 2
        else:
            r = abs(Bp[k, i])
            rs[i] = r
            if not conv(lam, r):
                break
            ncv = i + 1
            i += 1
    return ncv
