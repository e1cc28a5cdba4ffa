"""Algorithm configuration and verbosity.

The reference keeps tunables in module-level ``Ref`` cells under an
ALGO_CONFIG convention (reference: src/PeriodicSchurDecompositions.jl:285-302,
src/krylov.jl:150, src/rpschur2x2.jl:5).  Mutable globals are incompatible
with jit tracing, so here they live in a frozen dataclass that is threaded
into the jitted cores as a *static* argument; changing a flag recompiles.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """Static algorithm switches for the iteration cores.

    Mirrors the reference's ALGO_CONFIG refs
    (src/PeriodicSchurDecompositions.jl:285-302):

    * ``slicot_shifts``: use SLICOT's shift computation in the real periodic
      QR core instead of the LAPACK-dlahqr-style one.
    * ``slicot_convg``: use SLICOT's (laxer) deflation criterion instead of
      the Ahues-Tisseur style test.
    * ``at_pwr16``: the Ahues-Tisseur threshold is tightened to
      ``eps^(1 + at_pwr16/16)``.
    * ``extra_rq``: enable the extra final RQ stage in subdiagonal repair
      (reference :637-652; off by default like the reference, which notes
      MB03WD force-zeroes the leftover "even when wrong").  Honored by the
      real periodic QR core (ops/pqr_real.py repair branch).
    * ``eta_orth``: iterated Gram-Schmidt re-orthogonalization threshold used
      by the periodic Arnoldi process (reference: src/krylov.jl:150).
    * ``iterative_2x2``: recompute 2x2-block eigenvalues during reordering
      with the ITERATIVE complex single-shift 2x2 periodic QZ (MB03BB
      semantics, reference src/rpschur2x2.jl:9-235) instead of the default
      one-shot scaled window-block product.  The iterative scheme is the
      reference's robustness device for adversarial 2x2 cycles; the
      one-shot product is validated on graded p=20 cycles and stays the
      default.  Falls back to the one-shot value when the iteration does
      not converge.

    * ``allow_early_qr``: the reference's ``_allow_early_QR`` toggle
      (reference :301-302,768-801) — scan for two consecutive small
      subdiagonals below the window top and start the double-shift sweep
      there instead of at ``l`` (the LAPACK dlahqr early-start device that
      SLICOT carries).  OFF by default, exactly like the reference, which
      ships it disabled as "dangerous for some matrices".  Honored by the
      real periodic QR core; the sweep's first step then scales
      ``H1[m, m-1]`` by ``(1 - tau)`` (LAPACK's underflow-safe form of the
      reference's sign flip).
    """

    slicot_shifts: bool = False
    slicot_convg: bool = False
    at_pwr16: int = 4
    extra_rq: bool = False
    allow_early_qr: bool = False
    eta_orth: float = 1.0 / math.sqrt(2.0)
    iterative_2x2: bool = False
    # Periodic aggressive early deflation, used by the host-chunked real
    # generalized driver (ops/pqz_real.pqz_real_gen_core_chunked): every
    # ``aed_interval`` iterations the host takes the trailing ``aed_window``
    # window of the cycle, computes its (small, f64) periodic Schur form,
    # tests the spike column beta * Zw[0][0, :], and deflates every
    # trailing eigenvalue whose spike entries are negligible — converged
    # eigenvalues are harvested WITHOUT the sweeps the subdiagonal-decay
    # test would still need (the standard Braman-Byers-Mathias
    # accelerator, periodic form after Kressner; beyond the reference,
    # which has no AED).  All failures degrade to "no deflation".
    aed: bool = True
    aed_window: int = 0   # 0 = auto: min(48, max(16, n // 10))
    aed_interval: int = 0  # 0 = auto: max(24, n // 6)
    # AED engages only at n >= aed_min_n: below it the per-event host
    # round trips cost more than the sweeps they save.  An EXPLICIT
    # aed_window (> 0) bypasses the gate.
    aed_min_n: int = 192
    # Host-tail finish: once the active window has shrunk to <= host_tail,
    # ONE native window pQZ (beta = 0, everything deflates) finishes the
    # remaining problem in f64 on the host and writes back through the AED
    # apply path.  0 = auto: min(64, n // 8) when the native backend is
    # available; -1 = off.
    host_tail: int = 0
    # Max failed-block reorder moves per AED analysis.  Moving a failed
    # block to the window head costs an O(w) host ordschur swap chain; an
    # adversarial window can fail ~w/2 blocks and burn host time for
    # nothing.  The budget keeps the harvested trailing run plus a few
    # rescued blocks and stops; -1 = unlimited (the classical xLAQR3
    # behavior).
    aed_max_moves: int = 4

    def ulp_x(self, ulp: float) -> float:
        """Tightened Ahues-Tisseur relative threshold ``eps^(1+at_pwr16/16)``."""
        return ulp ** (1.0 + self.at_pwr16 / 16.0)


default_config = AlgoConfig()

# ----------------------------------------------------------------------------
# Verbosity: host-side only (never read inside traced code).  Mirrors
# setverbosity (reference: src/diagnostics.jl:5-31) with keyed channels.
_VERBOSITY = {
    "main": 0,
    "krylov": 0,
    "sylswap": 0,
    "rordschur": 0,
    "r2x2": 0,
}


def setverbosity(level: int, key: str = "main") -> None:
    """Set diagnostic verbosity for a subsystem.

    Keys: ``main`` (iteration cores), ``krylov``, ``sylswap``, ``rordschur``,
    ``r2x2``.  Levels: 0 silent, 1 progress, 2 chatty, 3+ matrix dumps.
    """
    if key not in _VERBOSITY:
        raise ValueError(f"unknown verbosity key {key!r}; known: {sorted(_VERBOSITY)}")
    _VERBOSITY[key] = int(level)


def verbosity(key: str = "main") -> int:
    return _VERBOSITY[key]
