"""Fast Sylvester residual path vs the trial-reorder probe: the
`_invariant_basis_at1` shortcut replaces the reference's per-candidate
trial ``ordschur`` (src/krylov.jl:833-919); on clustered spectra — where
the cyclic Sylvester levels go near-singular — the two must agree (or the
fast path must fall back), and the fast path must never report an
optimistically SMALL residual (the mis-lock hazard).
"""
import numpy as np
import pytest

from periodicschurdecompositions_jax.models.krylov import (
    _residual_trial, _residuals)
from periodicschurdecompositions_jax.types import PeriodicSchur


def _planted_ps(rng, p, k, diag0):
    """Synthetic right-oriented decomposition with Zs = I (mkrps-style
    fake backend, reference test/ordschur.jl:62-125): T[0] carries the
    planted diagonal, the rest are unit-diagonal triangulars."""
    import jax.numpy as jnp
    Ts = np.zeros((p, k, k))
    Ts[0] = np.triu(rng.standard_normal((k, k)) * 0.1, 1)
    np.fill_diagonal(Ts[0], diag0)
    for l in range(1, p):
        Ts[l] = np.triu(rng.standard_normal((k, k)) * 0.1, 1)
        np.fill_diagonal(Ts[l], 1.0 + 0.1 * rng.random(k))
    vals = np.ones(k, complex)
    for l in range(p):
        vals *= np.diag(Ts[l])
    Zs = np.broadcast_to(np.eye(k), (p, k, k)).copy()
    return PeriodicSchur(Ts=jnp.asarray(Ts), Zs=jnp.asarray(Zs),
                         values=jnp.asarray(vals), orientation="R",
                         schurindex=0), vals


@pytest.mark.parametrize("sep", [1e-6, 1e-13])
def test_fast_residuals_vs_trial_clustered(rng, sep):
    p, k = 3, 8
    # clustered leading triple: separation `sep` (1e-13 drives the
    # Sylvester levels to near-singularity)
    diag0 = np.array([1.0, 1.0 + sep, 1.0 + 2 * sep,
                      0.5, -0.7, 1.4, -1.1, 0.3])
    PS, vals = _planted_ps(rng, p, k, diag0)
    foot = rng.standard_normal(k)
    rs_fast = _residuals(PS, foot, list(range(k)), vals, isreal_t=True)
    for j in range(k):
        r_trial = _residual_trial(PS, foot, j, None, k)
        r_fast = rs_fast[j]
        assert np.isfinite(r_fast)
        if sep >= 1e-8:
            # well-separated enough: identical up to phase/roundoff
            assert r_fast == pytest.approx(r_trial, rel=1e-6, abs=1e-12), j
        else:
            # near-singular levels: agreement OR a conservative fallback,
            # but never an optimistic underestimate that could mis-lock
            assert r_fast >= 0.5 * min(r_trial, np.abs(foot).max()) \
                or r_fast == pytest.approx(r_trial, rel=1e-3), (j, r_fast,
                                                                r_trial)


def test_fast_residuals_conjugate_pairs(rng):
    """Real conjugate-pair blocks: the pair projection must match the
    trial probe within its documented sqrt(2) conservatism."""
    import jax.numpy as jnp
    p, k = 2, 6
    Ts = np.zeros((p, k, k))
    Ts[0] = np.triu(rng.standard_normal((k, k)) * 0.1, 1)
    np.fill_diagonal(Ts[0], [2.0, 2.0, 0.8, -0.6, 1.2, 0.4])
    # plant a standardized 2x2 pair at (0, 1)
    Ts[0][0, 1] = 1.0
    Ts[0][1, 0] = -0.25
    Ts[1] = np.triu(rng.standard_normal((k, k)) * 0.1, 1)
    np.fill_diagonal(Ts[1], 1.0 + 0.1 * rng.random(k))
    vals = np.ones(k, complex)
    M = np.eye(k)
    for l in range(p):
        M = M @ Ts[l]
    # eigenvalues of the product's diagonal blocks
    w = np.linalg.eigvals(M[:2, :2])
    vals[0] = w[0] if w[0].imag > 0 else w[1]
    vals[1] = np.conj(vals[0])
    for j in range(2, k):
        vals[j] = M[j, j]
    Zs = np.broadcast_to(np.eye(k), (p, k, k)).copy()
    PS = PeriodicSchur(Ts=jnp.asarray(Ts), Zs=jnp.asarray(Zs),
                       values=jnp.asarray(vals), orientation="R",
                       schurindex=0)
    foot = rng.standard_normal(k)
    rs_fast = _residuals(PS, foot, list(range(k)), vals, isreal_t=True)
    r_trial = _residual_trial(PS, foot, 0, 1, k)
    assert np.isfinite(rs_fast[0]) and rs_fast[0] == rs_fast[1]
    # 2-norm of the projected pair row vs max-|entry|: within sqrt(2) up
    # and never below the trial value by more than roundoff
    assert rs_fast[0] <= np.sqrt(2.0) * r_trial * (1 + 1e-8)
    assert rs_fast[0] >= r_trial * (1 - 1e-8) / np.sqrt(2.0)
