"""Periodic Schur decompositions in JAX / XLA.

A re-design (not a port) of the capabilities of
RalphAS/PeriodicSchurDecompositions.jl as jitted XLA programs.

Given a cycle of ``p`` square matrices ``A[0..p-1]`` (stored as one stacked
``(p, n, n)`` array), this package computes:

* the **periodic Schur decomposition** (``pschur``): unitary ``Z[j]`` with
  ``Z[j]' A[j] Z[(j+1) % p] = T[j]`` (right orientation), all ``T[j]`` upper
  triangular except one quasi-triangular factor for real dtypes,
* the **generalized periodic Schur decomposition** of a formal product
  ``prod_j A[j]^{s[j]}`` with signature ``s[j] = ±1`` (periodic QZ),
* **eigenvalue reordering** (``ordschur``) moving selected eigenvalues and
  their invariant subspace to the top,
* **eigenvectors** of the product (``eigvecs``),
* a **periodic Krylov-Schur** iteration (``partial_pschur``) for a few
  exterior eigenvalues of large products given only matvecs,

all without ever forming the matrix product (which would destroy accuracy).

Design (see SURVEY.md §7): the reference's scalar-sequential Fortran-style
iterations are re-expressed as statically shaped, fully jitted sweep kernels —
``lax.while_loop`` over QR/QZ iterations with deflation windows carried as
integer state, rotation/reflector chains as ``lax.scan``/``fori_loop`` over
masked 2- and 3-row slab updates, and the p-cycle unrolled (p is static).
Everything is functional: decompositions are pytrees, cores are pure and
jit/vmap-compatible.

Default compute dtype is float64/complex128 (``jax_enable_x64`` is switched on
at import) because the accuracy contract (backward error ≤ ~100·eps·n) is part
of the API.
"""
from __future__ import annotations

import jax as _jax

_jax.config.update("jax_enable_x64", True)
# XLA:GPU may run float32 matmuls in TF32 (about three decimal digits)
# unless told otherwise; this library's contract is LAPACK-grade accuracy,
# so demand full-precision matmuls everywhere (float64 is never affected).
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the iteration cores are large while_loop
# programs whose compiles take seconds to minutes, so every re-run in a
# fresh process pays that once.  An explicit JAX_COMPILATION_CACHE_DIR is
# read by JAX itself and left alone; otherwise the cache lives at one fixed,
# git-ignored path inside the checkout (a moving path never hits).
import os as _os  # noqa: E402

_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)

from .types import (  # noqa: E402
    AbstractPeriodicSchur,
    GeneralizedPeriodicSchur,
    IllConditionedException,
    PSDNotImplemented,
    PartialPeriodicSchur,
    PeriodicSchur,
    PKSFailure,
)
from .config import AlgoConfig, default_config, setverbosity, verbosity  # noqa: E402
from .diagnostics import check_psd, FacChecker  # noqa: E402
from .models.drivers import (  # noqa: E402
    gpschur,
    phessenberg,
    pschur,
)
from .models.ordschur import ordschur  # noqa: E402
from .models.vectors import eigvecs  # noqa: E402
from .models.krylov import partial_pschur, ArnoldiHistory  # noqa: E402
from .utils.io import load_decomposition, save_decomposition  # noqa: E402
from .utils.balance import balance_pcycle  # noqa: E402
from .ops.pqz_mp import MpGeneralizedPeriodicSchur, pschur_mp  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AbstractPeriodicSchur",
    "PeriodicSchur",
    "GeneralizedPeriodicSchur",
    "PartialPeriodicSchur",
    "IllConditionedException",
    "PKSFailure",
    "PSDNotImplemented",
    "AlgoConfig",
    "default_config",
    "setverbosity",
    "verbosity",
    "pschur",
    "gpschur",
    "phessenberg",
    "ordschur",
    "eigvecs",
    "partial_pschur",
    "ArnoldiHistory",
    "check_psd",
    "FacChecker",
    "save_decomposition",
    "balance_pcycle",
    "load_decomposition",
    "pschur_mp",
    "MpGeneralizedPeriodicSchur",
]
