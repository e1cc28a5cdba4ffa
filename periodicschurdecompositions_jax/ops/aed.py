"""Periodic aggressive early deflation (AED) window analyses.

The classic QR accelerator (Braman-Byers-Mathias; LAPACK xLAQR3), in its
periodic form (after Kressner's multishift/AED work on the periodic QR
algorithm): take the trailing ``w``-window of the active cycle, compute its
(small) periodic Schur form, and examine the *spike* — the window's coupling
column ``beta * Zw[0][0, :]`` that materializes when the window transforms
are applied to the Hessenberg factor.  Every trailing eigenvalue block whose
spike entries are negligible is CONVERGED even though the subdiagonal decay
test cannot see it yet; zeroing those entries (a backward-stable
perturbation) deflates it without any further sweeps.  Non-deflatable blocks
are reordered out of the way and the remaining window is returned to
periodic Hessenberg form around the compressed spike.

The reference has no AED (SURVEY §2: its cores are straight SLICOT
translations); this is a beyond-reference convergence accelerator.  It runs
HOST-side between device chunks of the real generalized chunked driver
(`ops/pqz_real.pqz_real_gen_core_chunked`): the window analysis is small
dense f64 (numpy, the native C++ cores, or the exact jitted cores on the
CPU), and only the final orthogonal window transforms touch the device
state (:func:`aed_apply_rg`).  Every failure path degrades to "no
deflation".
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# running tallies (host-side observability, in the spirit of the library's
# with_info counters; tests also read these)
stats = {"passes": 0, "deflated": 0}


def _cpu_device():
    return jax.devices("cpu")[0]


def _host_only(fn):
    """Run the whole analysis under the CPU default device.

    The analyses are small, sequential host work (accept/reject decisions
    in numpy), but they build small jax arrays (PeriodicSchur fields,
    ordschur updates).  Pinned to the CPU, each such array costs no
    transfer and each new tiny shape a CPU compile, instead of a device
    launch per scalar step."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_device(_cpu_device()):
            return fn(*args, **kwargs)

    return wrapper


def _window_schur(Hwin: np.ndarray):
    """Exact-f64 periodic Schur of the window cycle (host).

    Native-first: the C++ backend (native/pschur_cpu.cpp) solves the
    window with no compile, where the jitted core compiles once per
    window shape.  Falls back to the jitted exact-f64 core when the native
    library is unavailable; both produce A = Z T Z' with identical
    conventions.
    """
    from .. import native
    if native.available():
        try:
            T, Z, wr, wi = native.pschur_real_cpu(np.asarray(Hwin,
                                                             np.float64))
            return T, Z, wr, wi
        except (RuntimeError, ValueError):
            pass  # native non-convergence: fall through to the jitted
            # exact-f64 core (mirrors _window_gpsd's decline handling —
            # it may still converge and deliver the deflations)
    from .pqr_real import pqr_real_core
    with jax.default_device(_cpu_device()):
        T, Z, wr, wi, ok = pqr_real_core(jnp.asarray(Hwin), want_z=True)
    if not bool(ok):
        return None
    return (np.asarray(T), np.asarray(Z), np.asarray(wr), np.asarray(wi))


def _phess_window(Awin: np.ndarray):
    """Exact-f64 periodic Hessenberg reduction of the window cycle."""
    from .hessenberg import phessenberg_core
    with jax.default_device(_cpu_device()):
        H, Q = phessenberg_core(jnp.asarray(Awin), want_q=True)
    return np.asarray(H), np.asarray(Q)


@_host_only
def aed_analyze(Hwin: np.ndarray, beta: float, tol: float,
                max_moves: Optional[int] = None
                ) -> Optional[Tuple[int, np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]]:
    """Analyze a trailing window for early deflations (host, f64).

    Args:
      Hwin: (p, w, w) float64 window; Hwin[0] upper Hessenberg (the window
        of the active Hessenberg factor), Hwin[1:] upper triangular.
      beta: the coupling entry H0[s, s-1] (0 at the window head).
      tol: absolute spike-negligibility threshold.  Zeroing a spike entry
        perturbs H0 by exactly that entry, so callers pass
        ulp * sqrt(n) * max|H0|, a max-norm scale (the classical
        ulp * n * opnorm1 scale is ~n times looser at large n).

    Returns None when nothing deflates, else
      (d, Wfinal, Ztot, values, spike_head):
      d: number of deflated eigenvalues (trailing d window slots);
      Wfinal: (p, w, w) new window stack — leading (w-d) back in periodic
        Hessenberg form, trailing d standardized quasi-triangular;
      Ztot: (p, w, w) orthogonal window transforms (Z_l <- Z_l @ Ztot_l);
      values: (w,) complex eigenvalues (trailing d slots are the deflated,
        now-final eigenvalues);
      spike_head: (w,) new H0[s:s+w, s-1] column (alpha e1 pattern).
    """
    from ..models.ordschur import ordschur
    from ..types import IllConditionedException, PeriodicSchur

    p, w, _ = Hwin.shape
    out = _window_schur(Hwin)
    if out is None:
        return None
    Tw, Zw, wr, wi = out
    vals = wr + 1j * wi
    PS = PeriodicSchur(Ts=jnp.asarray(Tw), Zs=jnp.asarray(Zw),
                       values=jnp.asarray(vals), orientation="R",
                       schurindex=0)

    def spike_of(PSx):
        return beta * np.asarray(PSx.Zs)[0][0, :]

    spike = spike_of(PS)
    T0 = np.asarray(PS.Ts)[0]
    kbot = w
    kept = 0
    moves = 0
    while kbot > kept:
        # block size from T[0]'s ACTUAL subdiagonal, NOT the eigenvalue
        # imaginary parts: ordschur's 2x2 re-solve can round a tiny pair
        # to exactly-real eigenvalues while the block stays 2x2 — a
        # bs=1 decision there would zero a genuine O(1) subdiagonal
        bs = 2 if (kbot >= 2 and T0[kbot - 1, kbot - 2] != 0) else 1
        if bs == 2 and kbot - 2 < kept:
            break  # half a pair at the boundary: stop
        if np.abs(spike[kbot - bs:kbot]).max() <= tol:
            kbot -= bs  # deflate in place
            continue
        if kept == kbot - bs:
            kept += bs  # already at the top of the undecided region
            continue
        if max_moves is not None and moves >= max_moves:
            break  # move budget spent: keep the harvested tail
        # move the failed block out of the way (to position `kept`)
        select = np.zeros(w, bool)
        select[:kept] = True
        select[kbot - bs:kbot] = True
        try:
            PS = ordschur(PS, list(select))
        except IllConditionedException:
            break  # stop reordering; keep what is already deflated
        spike = spike_of(PS)
        T0 = np.asarray(PS.Ts)[0]
        kept += bs
        moves += 1
    d = w - kbot
    stats["passes"] += 1
    if d == 0:
        return None
    u = kbot
    Tw = np.asarray(PS.Ts)
    Zw = np.asarray(PS.Zs)
    lams = np.asarray(PS.values)

    # ---- compress the live spike + re-Hessenberg the leading window -----
    V = np.broadcast_to(np.eye(w), (p, w, w)).copy()
    spike_head = np.zeros(w)
    if u > 0:
        sp = spike[:u].copy()
        nrm = np.linalg.norm(sp)
        if nrm > 0.0:
            # Householder P (symmetric orthogonal): P @ sp = alpha e1
            alpha = -nrm if sp[0] >= 0 else nrm
            v = sp.copy()
            v[0] -= alpha
            vn2 = v @ v
            P = np.eye(u)
            if vn2 > 0.0:
                P -= 2.0 * np.outer(v, v) / vn2
            spike_head[0] = alpha
            # V_0 = P @ W_0 appears on BOTH factor 0's left and factor
            # p-1's right: reduce the cycle (P T_0, T_1, .., T_{p-1} P)
            # with the standard periodic Hessenberg reduction, whose W_0
            # is a product of e1-preserving reflectors — the compressed
            # spike direction survives exactly.  The leading-u problem is
            # embedded block-diagonally at the FULL window size so every
            # AED pass reuses ONE compiled (p, w) reduction (a fresh
            # compile per distinct u costs ~a minute each at p=16).
            Pw = np.eye(w)
            Pw[:u, :u] = P
            if p == 1:
                Aw = (Pw @ Tw[0] @ Pw)[None]
            else:
                Aw = np.stack([Pw @ Tw[0]] +
                              [Tw[l] for l in range(1, p - 1)] +
                              [Tw[p - 1] @ Pw])
            # decouple the deflated trailing block: the reduction must not
            # mix it with the live window (blockdiag inputs stay blockdiag
            # through QR/Hessenberg stages; zeroing makes that exact)
            Aw[:, u:, :u] = 0.0
            Aw[:, :u, u:] = 0.0
            for l in range(p):
                Aw[l, u:, u:] = np.eye(d)
            Hw, Qw = _phess_window(Aw)
            e1err = np.abs(Qw[0][:, 0] - np.eye(w)[:, 0]).max()
            offd = max(np.abs(Qw[l][:u, u:]).max()
                       for l in range(p))
            if not (np.isfinite(e1err) and e1err <= 1e-12 and
                    offd <= 1e-12):
                return None  # defensive: never corrupt the spike direction
            for l in range(p):
                lead = (P @ Qw[l][:u, :u]) if l == 0 else Qw[l][:u, :u]
                V[l][:u, :u] = lead
        # nrm == 0: spike already compressed; leading Schur block is
        # triangular, hence Hessenberg — nothing to do

    Wfinal = np.empty_like(Tw)
    for l in range(p):
        Wfinal[l] = V[l].T @ Tw[l] @ V[(l + 1) % p]
    # exact structural zeros (the matmuls leave rounding junk)
    for l in range(p):
        Wfinal[l][u:, :u] = 0.0
        if l == 0:
            Wfinal[l][:u, :u] = np.triu(Wfinal[l][:u, :u], -1)
            # trailing block: quasi-triangular from the window Schur
            Wfinal[l][u:, u:] = np.triu(Wfinal[l][u:, u:], -1)
            keep = np.abs(np.diag(Tw[0][u:, u:], -1)) > 0
            sub = np.diag(Wfinal[l][u:, u:], -1) * keep
            Wfinal[l][u:, u:] = np.triu(Wfinal[l][u:, u:]) + np.diag(sub, -1)
        else:
            Wfinal[l] = np.triu(Wfinal[l])
    Ztot = np.empty_like(Zw)
    for l in range(p):
        Ztot[l] = Zw[l] @ V[l]
    stats["deflated"] += d  # only deflations that will actually be applied
    return d, Wfinal, Ztot, lams, spike_head


# ===========================================================================
# complex / generalized variant


def _window_gpsd(Hwin: np.ndarray, S):
    """Exact-f64 complex periodic QZ of the window cycle (host).

    Native-first (see _window_schur): the C++ single-shift pQZ solves
    the common nonsingular window with no compile; it DECLINES (returns
    None) on singular-factor windows and non-convergence, in which case the jitted exact core — with the
    full deflate_pos/neg + controlled-zero-shift machinery — takes
    over.
    """
    from .. import native
    if native.available():
        out = native.pqz_complex_cpu(np.asarray(Hwin, np.complex128), S)
        if out is not None:
            T, Z, al, be, sc = out
            return T, Z, al, be, sc
        # declined: fall through to the full-machinery jitted core
    from .pqz_complex import pqz_complex_core
    with jax.default_device(_cpu_device()):
        T, Z, al, be, sc, ok = pqz_complex_core(jnp.asarray(Hwin), S,
                                                want_z=True)
    if not bool(ok):
        return None
    return (np.asarray(T), np.asarray(Z), np.asarray(al), np.asarray(be),
            np.asarray(sc))


def _phess_window_signed(Awin: np.ndarray, S):
    from .hessenberg import phessenberg_signed_core
    with jax.default_device(_cpu_device()):
        H, Q = phessenberg_signed_core(jnp.asarray(Awin), S, want_q=True)
    return np.asarray(H), np.asarray(Q)


@_host_only
def aed_analyze_cx(Hwin: np.ndarray, S, beta: complex, tol: float,
                   max_moves: Optional[int] = None):
    """Complex/generalized AED window analysis (host, complex128 f64).

    Mirror of :func:`aed_analyze` for the signed complex QZ: the window
    periodic Schur form comes from the complex GPSD core, deflation moves
    through the generalized ``ordschur``, and the spike-compression
    reduction is the SIGNED Hessenberg-triangular reduction — the
    compression Householder P enters factor 0's left side and factor
    p-1's right (direct) or left (inverted) side.

    Returns None or (d, Wfinal, Ztot, alpha, beta_e, scale, spike_head):
    eigenvalues in the decomposed (alpha, beta, 2^scale) form of the core's
    state; trailing d slots are final.
    """
    from ..models.ordschur import ordschur
    from ..types import GeneralizedPeriodicSchur, IllConditionedException

    p, w, _ = Hwin.shape
    out = _window_gpsd(Hwin, S)
    if out is None:
        return None
    Tw, Zw, al, be, sc = out
    GPS = GeneralizedPeriodicSchur(
        S=tuple(bool(x) for x in S), schurindex=0, Ts=jnp.asarray(Tw),
        Zs=jnp.asarray(Zw), alpha=jnp.asarray(al), beta=jnp.asarray(be),
        alphascale=jnp.asarray(sc), orientation="R")

    def spike_of(PSx):
        return beta * np.conj(np.asarray(PSx.Zs)[0][0, :])

    spike = spike_of(GPS)
    kbot = w
    kept = 0
    moves = 0
    while kbot > kept:
        if abs(spike[kbot - 1]) <= tol:
            kbot -= 1
            continue
        if kept == kbot - 1:
            kept += 1
            continue
        if max_moves is not None and moves >= max_moves:
            break  # move budget spent: keep the harvested tail
        select = np.zeros(w, bool)
        select[:kept] = True
        select[kbot - 1] = True
        try:
            GPS = ordschur(GPS, list(select))
        except IllConditionedException:
            break
        spike = spike_of(GPS)
        kept += 1
        moves += 1
    d = w - kbot
    stats["passes"] += 1
    if d == 0:
        return None
    u = kbot
    Tw = np.asarray(GPS.Ts)
    Zw = np.asarray(GPS.Zs)
    al = np.asarray(GPS.alpha)
    be = np.asarray(GPS.beta)
    sc = np.asarray(GPS.alphascale)

    V = np.broadcast_to(np.eye(w, dtype=complex), (p, w, w)).copy()
    spike_head = np.zeros(w, dtype=complex)
    if u > 0:
        sp = spike[:u].copy()
        nrm = np.linalg.norm(sp)
        if nrm > 0.0:
            phase = sp[0] / abs(sp[0]) if sp[0] != 0 else 1.0
            alpha = -phase * nrm
            v = sp.copy()
            v[0] -= alpha
            vn2 = float(np.real(np.conj(v) @ v))
            P = np.eye(u, dtype=complex)
            if vn2 > 0.0:
                P -= 2.0 * np.outer(v, np.conj(v)) / vn2
            spike_head[0] = alpha
            Pw = np.eye(w, dtype=complex)
            Pw[:u, :u] = P
            if p == 1:
                Aw = (Pw @ Tw[0] @ Pw)[None]
            else:
                mids = [Tw[l] for l in range(1, p - 1)]
                last = (Tw[p - 1] @ Pw) if S[p - 1] else (Pw @ Tw[p - 1])
                Aw = np.stack([Pw @ Tw[0]] + mids + [last])
            Aw[:, u:, :u] = 0.0
            Aw[:, :u, u:] = 0.0
            for l in range(p):
                Aw[l, u:, u:] = np.eye(d)
            Hw, Qw = _phess_window_signed(Aw, tuple(bool(x) for x in S))
            e1err = np.abs(Qw[0][:, 0] - np.eye(w, dtype=complex)[:, 0]).max()
            offd = max(np.abs(Qw[l][:u, u:]).max()
                       for l in range(p))
            if not (np.isfinite(e1err) and e1err <= 1e-12 and
                    offd <= 1e-12):
                return None
            for l in range(p):
                lead = (P @ Qw[l][:u, :u]) if l == 0 else Qw[l][:u, :u]
                V[l][:u, :u] = lead

    Wfinal = np.empty_like(Tw)
    for l in range(p):
        ln = (l + 1) % p
        if S[l]:
            Wfinal[l] = V[l].conj().T @ Tw[l] @ V[ln]
        else:
            Wfinal[l] = V[ln].conj().T @ Tw[l] @ V[l]
        Wfinal[l][u:, :u] = 0.0
        Wfinal[l] = np.triu(Wfinal[l], -1 if l == 0 else 0)
    Ztot = np.empty_like(Zw)
    for l in range(p):
        Ztot[l] = Zw[l] @ V[l]
    stats["deflated"] += d
    return d, Wfinal, Ztot, al, be, sc, spike_head


# ===========================================================================
# real generalized variant (the real QZ chunked driver)


def _window_rgpsd(Hwin: np.ndarray, S):
    """Exact-f64 real generalized periodic QZ of the window cycle (host).

    Native-first (see _window_gpsd): the C++ real pQZ
    (native/pschur_cpu.cpp::pqz_real_gen_cpu, the re-designed MB03BD
    scope of ops/pqz_real.py) solves the common nonsingular window with
    no compile, where the jitted core compiles once per (p, w, S) shape.
    It DECLINES (returns None) on singular-factor
    windows and non-convergence, in which case the jitted exact core —
    with the full deflate_pos/neg + controlled-zero-shift machinery —
    takes over.  Validated against the jitted core to ~1e-14
    (tests/test_native_rg.py).
    """
    from .. import native
    if native.available():
        try:
            out = native.pqz_real_gen_cpu(np.asarray(Hwin, np.float64), S)
        except RuntimeError:
            out = None  # stale cached .so without the symbol
        if out is not None:
            T, Z, ar, ai, be, sc = out
            return T, Z, ar, ai, be, sc
        # declined: fall through to the full-machinery jitted core
    from .pqz_real import pqz_real_gen_core
    with jax.default_device(_cpu_device()):
        T, Z, ar, ai, be, sc, ok = pqz_real_gen_core(jnp.asarray(Hwin), S,
                                                     want_z=True)
    if not bool(ok):
        return None
    return (np.asarray(T), np.asarray(Z), np.asarray(ar), np.asarray(ai),
            np.asarray(be), np.asarray(sc))


@_host_only
def aed_analyze_rg(Hwin: np.ndarray, S, beta: float, tol: float,
                   max_moves: Optional[int] = None):
    """Real generalized AED window analysis (host, f64).

    Real quasi-triangular blocks (2x2 pairs) + signatures: the window
    Schur comes from the real GPSD core, deflation moves through the real
    generalized ``ordschur``, spike compression mirrors
    :func:`aed_analyze_cx`'s signed placement.  Returns None or
    (d, Wfinal, Ztot, alpha_r, alpha_i, beta_e, scale, spike_head).
    """
    from ..models.ordschur import ordschur
    from ..types import GeneralizedPeriodicSchur, IllConditionedException

    p, w, _ = Hwin.shape
    out = _window_rgpsd(Hwin, S)
    if out is None:
        return None
    Tw, Zw, ar, ai, be, sc = out
    GPS = GeneralizedPeriodicSchur(
        S=tuple(bool(x) for x in S), schurindex=0, Ts=jnp.asarray(Tw),
        Zs=jnp.asarray(Zw), alpha=jnp.asarray(ar + 1j * ai),
        beta=jnp.asarray(be), alphascale=jnp.asarray(sc), orientation="R")

    def spike_of(PSx):
        return beta * np.asarray(PSx.Zs)[0][0, :]

    spike = spike_of(GPS)
    T0 = np.asarray(GPS.Ts)[0]
    kbot = w
    kept = 0
    moves = 0
    while kbot > kept:
        # block size from T[0]'s subdiagonal (see aed_analyze note)
        bs = 2 if (kbot >= 2 and T0[kbot - 1, kbot - 2] != 0) else 1
        if bs == 2 and kbot - 2 < kept:
            break
        if np.abs(spike[kbot - bs:kbot]).max() <= tol:
            kbot -= bs
            continue
        if kept == kbot - bs:
            kept += bs
            continue
        if max_moves is not None and moves >= max_moves:
            break  # move budget spent: keep the harvested tail
        select = np.zeros(w, bool)
        select[:kept] = True
        select[kbot - bs:kbot] = True
        try:
            GPS = ordschur(GPS, list(select))
        except IllConditionedException:
            break
        spike = spike_of(GPS)
        T0 = np.asarray(GPS.Ts)[0]
        kept += bs
        moves += 1
    d = w - kbot
    stats["passes"] += 1
    if d == 0:
        return None
    u = kbot
    Tw = np.asarray(GPS.Ts)
    Zw = np.asarray(GPS.Zs)
    alc = np.asarray(GPS.alpha)
    be = np.asarray(GPS.beta)
    sc = np.asarray(GPS.alphascale)

    V = np.broadcast_to(np.eye(w), (p, w, w)).copy()
    spike_head = np.zeros(w)
    if u > 0:
        sp = spike[:u].copy()
        nrm = np.linalg.norm(sp)
        if nrm > 0.0:
            alpha = -nrm if sp[0] >= 0 else nrm
            v = sp.copy()
            v[0] -= alpha
            vn2 = v @ v
            P = np.eye(u)
            if vn2 > 0.0:
                P -= 2.0 * np.outer(v, v) / vn2
            spike_head[0] = alpha
            Pw = np.eye(w)
            Pw[:u, :u] = P
            if p == 1:
                Aw = (Pw @ Tw[0] @ Pw)[None]
            else:
                mids = [Tw[l] for l in range(1, p - 1)]
                last = (Tw[p - 1] @ Pw) if S[p - 1] else (Pw @ Tw[p - 1])
                Aw = np.stack([Pw @ Tw[0]] + mids + [last])
            Aw[:, u:, :u] = 0.0
            Aw[:, :u, u:] = 0.0
            for l in range(p):
                Aw[l, u:, u:] = np.eye(d)
            Hw, Qw = _phess_window_signed(Aw, tuple(bool(x) for x in S))
            Qw = np.asarray(Qw).real
            e1err = np.abs(Qw[0][:, 0] - np.eye(w)[:, 0]).max()
            offd = max(np.abs(Qw[l][:u, u:]).max()
                       for l in range(p))
            if not (np.isfinite(e1err) and e1err <= 1e-12 and
                    offd <= 1e-12):
                return None
            for l in range(p):
                lead = (P @ Qw[l][:u, :u]) if l == 0 else Qw[l][:u, :u]
                V[l][:u, :u] = lead

    Wfinal = np.empty_like(Tw)
    for l in range(p):
        ln = (l + 1) % p
        if S[l]:
            Wfinal[l] = V[l].T @ Tw[l] @ V[ln]
        else:
            Wfinal[l] = V[ln].T @ Tw[l] @ V[l]
        Wfinal[l][u:, :u] = 0.0
        if l == 0:
            Wfinal[l][:u, :u] = np.triu(Wfinal[l][:u, :u], -1)
            Wfinal[l][u:, u:] = np.triu(Wfinal[l][u:, u:], -1)
            keep = np.abs(np.diag(Tw[0][u:, u:], -1)) > 0
            sub = np.diag(Wfinal[l][u:, u:], -1) * keep
            Wfinal[l][u:, u:] = np.triu(Wfinal[l][u:, u:]) + np.diag(sub, -1)
        else:
            Wfinal[l] = np.triu(Wfinal[l])
    Ztot = np.empty_like(Zw)
    for l in range(p):
        Ztot[l] = Zw[l] @ V[l]
    stats["deflated"] += d
    return d, Wfinal, Ztot, alc.real, alc.imag, be, sc, spike_head


@partial(jax.jit, static_argnames=("S", "want_z"))
def aed_apply_rg(H, Z, Zt, Wf, sp, s, S, want_z: bool = True):
    """Apply real-generalized AED transforms to the float64 state.

    ``H`` relations follow the signature (H_l = Z_l^T A_l Z_{l+1} direct /
    Z_{l+1}^T A_l Z_l inverted), so factor l's left transform is V_l
    (direct) or V_{l+1} (inverted) and vice versa on the right; Z_l always
    takes V_l on its columns.  The window block is replaced by the host
    result ``Wf`` and the spike column by ``sp``.
    """
    p, N, _ = H.shape
    w = Zt.shape[-1]
    s = jnp.asarray(s, jnp.int32)
    zero32 = jnp.int32(0)
    Zt = Zt.astype(H.dtype)
    Wf = Wf.astype(H.dtype)
    sp = sp.astype(H.dtype)
    for l in range(p):
        ln = (l + 1) % p
        Vleft = Zt[l] if S[l] else Zt[ln]
        Vright = Zt[ln] if S[l] else Zt[l]
        rows = jax.lax.dynamic_slice(H[l], (s, zero32), (w, N))
        H = H.at[l].set(jax.lax.dynamic_update_slice(
            H[l], Vleft.T @ rows, (s, zero32)))
        cols = jax.lax.dynamic_slice(H[l], (zero32, s), (N, w))
        H = H.at[l].set(jax.lax.dynamic_update_slice(
            H[l], cols @ Vright, (zero32, s)))
        H = H.at[l].set(jax.lax.dynamic_update_slice(H[l], Wf[l], (s, s)))
        if want_z:
            zc = jax.lax.dynamic_slice(Z[l], (zero32, s), (N, w))
            Z = Z.at[l].set(jax.lax.dynamic_update_slice(
                Z[l], zc @ Zt[l], (zero32, s)))
    sc_ = jnp.maximum(s - 1, 0)
    old = jax.lax.dynamic_slice(H[0], (s, sc_), (w, 1))
    spc = jnp.where(s >= 1, sp[:, None], old)
    H = H.at[0].set(jax.lax.dynamic_update_slice(H[0], spc, (s, sc_)))
    return H, Z
