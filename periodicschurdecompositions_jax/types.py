"""Result types (pytree dataclasses) and typed failures.

Mirrors the reference's result structs (PeriodicSchur:
src/PeriodicSchurDecompositions.jl:59-92, GeneralizedPeriodicSchur:
src/generalized.jl:31-85, PartialPeriodicSchur: src/krylov.jl:98-147) with a
device-friendly layout: the factor cycle is ONE stacked ``(p, n, n)`` array
rather than a list of matrices, so the whole decomposition ships to device as a
single pytree and vmaps over problem batches.

Conventions (all indices 0-based):

* right orientation ('R'): ``Z[j]' A[j] Z[(j+1)%p] = T[j]`` and the
  decomposition represents ``A[0] @ A[1] @ ... @ A[p-1]``.
* left orientation ('L'): ``Z[(j+1)%p]' A[j] Z[j] = T[j]`` representing
  ``A[p-1] @ ... @ A[1] @ A[0]``.
* ``schurindex``: which factor is (quasi-)triangular Schur form; all others
  are upper triangular.
* generalized eigenvalues are kept in decomposed form ``alpha/beta * 2^scale``
  with ``|alpha| ∈ [1,2) ∪ {0}`` and ``beta ∈ {0,1}`` (beta=0 encodes an
  infinite eigenvalue from a singular inverted factor), matching the
  reference's `_safeprod` representation (src/generalized.jl:933-976).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


class IllConditionedException(Exception):
    """An operation on a decomposition failed due to ill-conditioning.

    ``info`` may be the index of the eigenvalue associated with the failure
    (reference: src/PeriodicSchurDecompositions.jl:19-28).
    """

    def __init__(self, info: int = -1):
        super().__init__(f"ill-conditioned problem (info={info})")
        self.info = info


class PSDNotImplemented(Exception):
    """A requested variant is not implemented (reference NotImplemented)."""


class PKSFailure(Exception):
    """Periodic Krylov-Schur failure (reference: src/krylov.jl:20-22)."""


class ConvergenceFailure(Exception):
    """An iteration core failed to converge within its budget."""

    def __init__(self, level: int = -1):
        super().__init__(f"convergence failed at level {level}")
        self.level = level


def _pytree_dataclass(cls, data_fields, meta_fields):
    cls = dataclasses.dataclass(frozen=True)(cls)
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


class AbstractPeriodicSchur:
    """Common base for periodic Schur factorizations."""

    @property
    def period(self) -> int:
        return int(self.Ts.shape[0])

    @property
    def n(self) -> int:
        return int(self.Ts.shape[-1])

    @property
    def T1(self):
        """The (quasi-)triangular Schur factor (factor ``schurindex``)."""
        return self.Ts[self.schurindex]

    @property
    def T(self):
        """The remaining triangular factors, in cyclic order after T1.

        Matches the reference's ``P.T`` layout for schurindex=0/'R'
        (src/PeriodicSchurDecompositions.jl:55).
        """
        p = self.period
        return [self.Ts[(self.schurindex + 1 + i) % p] for i in range(p - 1)]

    @property
    def Z(self):
        """List of the p unitary factors (None when not computed)."""
        if self.Zs is None:
            return None
        return [self.Zs[j] for j in range(self.period)]


class PeriodicSchur(AbstractPeriodicSchur):
    """Periodic Schur factorization of a cycle ``A[0..p-1]``.

    Fields:
      Ts: (p, n, n) stacked factors; ``Ts[schurindex]`` is quasi-triangular
          for real dtypes, all others upper triangular.
      Zs: (p, n, n) stacked unitary factors, or None if not requested.
      values: (n,) complex eigenvalues of the cyclic product.
      orientation: 'R' or 'L' (static).
      schurindex: which factor carries the (quasi-)triangular Schur form
          (static, 0-based).
    """

    Ts: jax.Array
    Zs: Optional[jax.Array]
    values: jax.Array
    orientation: str = "R"
    schurindex: int = 0


PeriodicSchur = _pytree_dataclass(
    PeriodicSchur, data_fields=("Ts", "Zs", "values"),
    meta_fields=("orientation", "schurindex"),
)


class GeneralizedPeriodicSchur(AbstractPeriodicSchur):
    """Generalized periodic Schur factorization of ``prod_j A[j]^{s[j]}``.

    Fields:
      S: static tuple of bool; True ⇒ factor enters the product directly,
         False ⇒ factor enters inverted (sign -1).
      schurindex: index of the (quasi-)triangular Schur factor (static).
      Ts, Zs: stacked factors as in PeriodicSchur.
      alpha: (n,) scaled eigenvalue numerators, |alpha| ∈ [1,2) ∪ {0}.
      beta: (n,) real; 1, or 0 to encode an infinite eigenvalue.
      alphascale: (n,) int32 power-of-two exponents.
      orientation: 'R' or 'L' (static).
    """

    S: Tuple[bool, ...]
    schurindex: int
    Ts: jax.Array
    Zs: Optional[jax.Array]
    alpha: jax.Array
    beta: jax.Array
    alphascale: jax.Array
    orientation: str = "R"

    @property
    def period(self) -> int:
        return len(self.S)

    @property
    def values(self):
        """Eigenvalues ``alpha / beta * 2^alphascale`` (inf when beta==0)."""
        two = jnp.asarray(2.0, dtype=self.alpha.real.dtype)
        return self.alpha / self.beta * two ** self.alphascale.astype(self.alpha.real.dtype)


GeneralizedPeriodicSchur = _pytree_dataclass(
    GeneralizedPeriodicSchur,
    data_fields=("Ts", "Zs", "alpha", "beta", "alphascale"),
    meta_fields=("S", "schurindex", "orientation"),
)


class PartialPeriodicSchur(AbstractPeriodicSchur):
    """Partial periodic Schur decomposition from ``partial_pschur``.

    Left orientation only (like the reference, src/krylov.jl:98-147):
    ``A[l] V[l] = V[(l+1) % p] T[l]`` column-wise for the leading ``k``
    columns, with ``T[p-1]`` (the "Schur" slot) quasi-triangular.

    Fields:
      Ts: (p, k, k) small projected factors.
      Vs: (p, n, k) stacked orthonormal bases.
      values: (k,) converged eigenvalue estimates of the product.
      residuals: (k,) residual estimates for each eigenvalue.
    """

    Ts: jax.Array
    Vs: jax.Array
    values: jax.Array
    residuals: jax.Array
    orientation: str = "L"
    schurindex: int = 0

    @property
    def Q(self):
        return [self.Vs[j] for j in range(self.period)]


PartialPeriodicSchur = _pytree_dataclass(
    PartialPeriodicSchur,
    data_fields=("Ts", "Vs", "values", "residuals"),
    meta_fields=("orientation", "schurindex"),
)
