"""Public decomposition drivers.

API parity with the reference's exported surface
(src/PeriodicSchurDecompositions.jl:108-177, src/generalized.jl:87-148,
:1191-1211): ``pschur`` (standard and generalized via the ``S`` argument),
``gpschur`` (A/B-pair convenience), ``phessenberg``.

All drivers accept either a stacked ``(p, n, n)`` array or a sequence of
``(n, n)`` matrices, are functional (inputs never mutated), and return the
pytree result types of :mod:`..types`.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..types import ConvergenceFailure, GeneralizedPeriodicSchur, PeriodicSchur
from ..utils.circshift import rev_alias
from ..ops.hessenberg import phessenberg_core, phessenberg_signed_core
from ..ops.pqz_complex import pqz_complex_core


BACKENDS = ("auto", "complex", "split")


def _stack(A) -> jax.Array:
    A = jnp.stack([jnp.asarray(a) for a in A]) \
        if not hasattr(A, "ndim") else jnp.asarray(A)
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"expected a (p, n, n) cycle, got shape {A.shape}")
    return A


@functools.lru_cache(maxsize=None)
def native_complex128(device) -> bool:
    """Whether ``device`` computes complex128 in true IEEE float64.

    The one capability query behind ``backend="auto"``: a value whose parts
    need float64's exponent range is doubled on the device and must come
    back exact.  A device without complex support refuses the transfer or
    the program, and one that emulates float64 loses the range; both
    answer False.  Probed once per device.
    """
    x = np.array([1e300 + 1e-300j])
    try:
        y = jax.jit(lambda v: v * 2.0)(jax.device_put(x, device))
        return bool(np.asarray(y)[0] == 2e300 + 2e-300j)
    except (jax.errors.JaxRuntimeError, TypeError, ValueError):
        return False


def _route_complex(A, backend: str) -> str:
    if backend != "auto":
        return backend
    dev = next(iter(A.devices()))
    return "complex" if native_complex128(dev) else "split"


def _char_lr(lr) -> str:
    s = str(lr).lstrip(":").upper()
    if s not in ("R", "L"):
        raise ValueError("orientation must be 'R' (right) or 'L' (left)")
    return s


def phessenberg(A, S: Optional[Sequence[bool]] = None, want_q: bool = True):
    """Periodic Hessenberg(-triangular) reduction of a cycle.

    Returns (H, Q): H[0] upper Hessenberg, H[1:] upper triangular, with
    ``Q[l]^H A[l] Q[(l+1)%p] = H[l]`` (direct factors) or
    ``Q[(l+1)%p]^H A[l] Q[l] = H[l]`` (inverted factors, when ``S`` given).
    """
    A = _stack(A)
    if S is None or all(bool(x) for x in S):
        return phessenberg_core(A, want_q=want_q)
    return phessenberg_signed_core(A, tuple(bool(x) for x in S), want_q=want_q)


def _pschur_complex_gen(A, S, orient, want_t, want_z, maxitfac,
                        backend="auto"):
    """Right-orientation complex GPSD pipeline on a stacked cycle.

    backend: "complex" runs the complex128 core, "split" the split-complex
    (re, im) float64 pair core (ops/pqz_complex_split.py); "auto" picks
    "complex" wherever the input's device computes complex128 natively.
    """
    p = A.shape[0]
    if orient == "L":
        A = A[::-1]
        S = tuple(reversed(S))
    if not S[0]:
        raise ValueError("the leftmost signature entry must be +1 (True); "
                         "rotate the cycle so a direct factor leads")
    if _route_complex(A, backend) == "split":
        return _pschur_complex_split(A, S, orient, want_t, want_z, maxitfac)
    if all(S):
        H, Q = phessenberg_core(A, want_q=want_z)
    else:
        H, Q = phessenberg_signed_core(A, S, want_q=want_z)
    from ..config import verbosity
    if verbosity("main") >= 1:
        T, Z, alpha, beta, scale, ok, info = pqz_complex_core(
            H, S, Z=Q, want_z=want_z, want_t=want_t, maxitfac=maxitfac,
            with_info=True)
        print(f"[pschur complex] p={p} n={A.shape[-1]}: "
              f"{int(info['niter'])} iterations "
              f"(budget {int(info['maxit'])}), converged={bool(ok)}")
    else:
        T, Z, alpha, beta, scale, ok = pqz_complex_core(
            H, S, Z=Q, want_z=want_z, want_t=want_t, maxitfac=maxitfac)
    if not bool(ok):
        raise ConvergenceFailure(-1)
    P = GeneralizedPeriodicSchur(
        S=S, schurindex=0, Ts=T, Zs=Z, alpha=alpha, beta=beta,
        alphascale=scale, orientation="R")
    if orient == "L":
        P = rev_alias(P)
    return P


def _pschur_complex_split(A, S, orient, want_t, want_z, maxitfac):
    """Split-complex pipeline: the QZ iteration on (re, im) float64 pairs.

    All-positive signatures reduce through the split Householder
    reduction; mixed signatures reduce with the complex128 signed
    Hessenberg-triangular reduction and split its result, so they need a
    device with complex128.
    """
    from ..ops.pqz_complex_split import (phessenberg_core_split,
                                         pqz_complex_core_split)
    if all(S):
        Hre, Him, Qre, Qim = phessenberg_core_split(
            jnp.real(A), jnp.imag(A), want_q=want_z)
    else:
        H, Q = phessenberg_signed_core(A, S, want_q=want_z)
        Hre, Him = jnp.real(H), jnp.imag(H)
        Qre, Qim = (jnp.real(Q), jnp.imag(Q)) if want_z else (None, None)
    from ..config import verbosity
    verbose = verbosity("main") >= 1
    out = pqz_complex_core_split(Hre, Him, S, Qre, Qim, want_z=want_z,
                                 want_t=want_t, maxitfac=maxitfac,
                                 with_info=verbose)
    (Tre, Tim, Zre, Zim, alr, ali, be, sc, ok) = out[:9]
    if verbose:
        print(f"[pschur split] p={A.shape[0]} n={A.shape[-1]}: "
              f"{int(out[9]['niter'])} iterations "
              f"(budget {int(out[9]['maxit'])}), converged={bool(ok)}")
    if not bool(ok):
        raise ConvergenceFailure(-1)
    P = GeneralizedPeriodicSchur(
        S=S, schurindex=0, Ts=jax.lax.complex(Tre, Tim),
        Zs=jax.lax.complex(Zre, Zim) if want_z else None,
        alpha=jax.lax.complex(alr, ali), beta=be, alphascale=sc,
        orientation="R")
    if orient == "L":
        P = rev_alias(P)
    return P


def pschur(A, lr="R", S: Optional[Sequence[bool]] = None, *,
           want_t: bool = True, want_z: bool = True,
           maxitfac: Optional[int] = None, aggressive: bool = False,
           backend: str = "auto"):
    """Periodic (generalized) Schur decomposition of a matrix cycle.

    Args:
      A: (p, n, n) stacked cycle or sequence of square matrices.
      lr: 'R' for the product ``A[0] @ ... @ A[p-1]``, 'L' for
          ``A[p-1] @ ... @ A[0]``.
      S: optional signature (True = direct, False = inverted factor);
         selects the generalized decomposition.
      want_t/want_z: keep the triangular/unitary factors.
      maxitfac: iteration budget factor (default 30).
      backend: routing of complex input, one of :data:`BACKENDS`:
        "complex" runs the complex128 core, "split" the split-complex
        (re, im) float64 pair core, and "auto" picks "complex" wherever
        the input's device computes complex128 natively (the CPU and the
        GPU both do).  Real input always runs the float64 cores.

    Returns:
      PeriodicSchur (S is None) or GeneralizedPeriodicSchur (S given).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid backends: "
                         f"{', '.join(BACKENDS)}")
    A = _stack(A)
    orient = _char_lr(lr)
    p = A.shape[0]
    mif = 30 if maxitfac is None else int(maxitfac)
    if aggressive and (S is None or
                       jnp.issubdtype(A.dtype, jnp.complexfloating)):
        # the reference defines aggressive deflation for the real
        # generalized decomposition only (src/rgeneralized.jl:7)
        raise ValueError("aggressive deflation applies to the real "
                         "generalized decomposition (real dtype + S) only")
    if jnp.issubdtype(A.dtype, jnp.complexfloating):
        if S is None:
            gps = _pschur_complex_gen(A, (True,) * p, orient, want_t,
                                      want_z, mif, backend=backend)
            return PeriodicSchur(Ts=gps.Ts, Zs=gps.Zs, values=gps.values,
                                 orientation=gps.orientation,
                                 schurindex=gps.schurindex)
        return _pschur_complex_gen(A, tuple(bool(x) for x in S), orient,
                                   want_t, want_z, mif, backend=backend)
    # real dtypes
    if S is None:
        from ..ops.pqr_real import pschur_real_pipeline
        return pschur_real_pipeline(A, orient, want_t=want_t, want_z=want_z,
                                    maxitfac=mif)
    # real generalized: the reference's real GPSD core,
    # src/rgeneralized.jl:49-1083
    from ..ops.pqz_real import pschur_real_gen_pipeline
    return pschur_real_gen_pipeline(A, tuple(bool(x) for x in S), orient,
                                    want_t=want_t, want_z=want_z,
                                    maxitfac=120 if maxitfac is None else mif,
                                    aggressive=aggressive)


def gpschur(As, Bs, **kwargs):
    """GPSD of the formal product ``B[p-1]^-1 A[p-1] ... B[0]^-1 A[0]``.

    Convenience builder matching the reference's `gpschur`
    (src/generalized.jl:1182-1211): interleaves the pairs into a length-2p
    signed cycle (terms shifted by one, which does not change eigenvalues).
    """
    As = [jnp.asarray(a) for a in As]
    Bs = [jnp.asarray(b) for b in Bs]
    ph = len(As)
    ib = 0 if ph == 1 else ph - 2
    Cs = [As[ph - 1], Bs[ib]]
    Ss = [True, False]
    for j in range(ph - 2, -1, -1):
        Cs.append(As[j])
        Cs.append(Bs[ph - 1 if j == 0 else j - 1])
        Ss.extend([True, False])
    C = jnp.stack(Cs)
    if not jnp.issubdtype(C.dtype, jnp.complexfloating):
        kwargs.setdefault("lr", "R")
    return pschur(C, kwargs.pop("lr", "R"), S=tuple(Ss), **kwargs)
