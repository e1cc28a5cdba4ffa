"""Adversarial draws for the re-designed real generalized shift scheme.

The library replaced the reference's MB03AF/MB03AB explicit-shift cascade
(reference src/rgeneralized.jl:64-66,804-887: 10 implicit / 1 explicit
alternation as stagnation insurance) with exact window-product Wilkinson
shifts plus random exceptional rotations every 10 sweeps
(ops/pqz_real.py module docstring).  These cases drive hostile draw classes
through the native C++ core, which runs the SAME shift scheme at a fraction
of the jitted core's cost, and require convergence well inside the 120n
budget (60n would justify the explicit-shift fallback) at contract-grade
backward error.

Classes:
  * exp-split: exponentially split spectra at p=20 and p=12 — factor
    diagonals graded fac^1..fac^3, so cycle eigenvalues span decades;
  * near-singular inverted factors: inverted-factor diagonals graded down
    to ~1e-10 (just above the deflation threshold, so the nonsingular fast
    path keeps them);
  * graded bands: plain Gaussian draws at p=8 n=128, whose product band
    grades across ~20 decades.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax import native
from periodicschurdecompositions_jax.ops.hessenberg import (
    phessenberg_signed_core)

EPS = np.finfo(np.float64).eps


def exp_split(p, n, fac, seed):
    """Exponentially split spectrum (reference testfuncs.jl:412-421
    pattern), mixed signature."""
    r = np.random.default_rng(seed)
    A = np.zeros((p, n, n))
    for l in range(p):
        d = fac ** (1 + 2 * r.random(n))
        Tl = np.triu(r.standard_normal((n, n)), 1) * d.max() * 0.1
        np.fill_diagonal(Tl, d)
        q1, _ = np.linalg.qr(r.standard_normal((n, n)))
        q2, _ = np.linalg.qr(r.standard_normal((n, n)))
        A[l] = q1 @ Tl @ q2.T
    S = tuple((l % 2 == 0) or (l == 0) for l in range(p))
    return A, S


def near_singular_inverted(p, n, floor, seed):
    r = np.random.default_rng(seed)
    A = r.standard_normal((p, n, n))
    S = tuple(l % 2 == 0 for l in range(p))
    for l in range(p):
        if not S[l]:
            Tl = np.triu(r.standard_normal((n, n)))
            np.fill_diagonal(
                Tl, np.logspace(0, np.log10(floor), n) * np.sign(
                    r.standard_normal(n)))
            q1, _ = np.linalg.qr(r.standard_normal((n, n)))
            q2, _ = np.linalg.qr(r.standard_normal((n, n)))
            A[l] = q1 @ Tl @ q2.T
    return A, S


def graded_band(p, n, seed):
    r = np.random.default_rng(seed)
    A = r.standard_normal((p, n, n))
    S = tuple(l % 2 == 0 for l in range(p))
    return A, S


CASES = (
    [pytest.param(exp_split, (20, 8, 2.0, s), id=f"exp-split-p20-n8-{s}")
     for s in range(5)]
    + [pytest.param(exp_split, (12, 16, 3.0, s), id=f"exp-split-p12-n16-{s}")
       for s in range(3)]
    + [pytest.param(near_singular_inverted, (6, 24, f, s),
                    id=f"near-sing-inv-{f:g}-{s}")
       for f in (1e-6, 1e-10) for s in range(2)]
    + [pytest.param(graded_band, (8, 128, s), id=f"graded-p8-n128-{s}")
       for s in range(2)]
)


@pytest.mark.parametrize("make,args", CASES)
def test_rg_hostile_converges(make, args):
    if not native.available():
        pytest.skip("native host library unavailable")
    A, S = make(*args)
    p, n, _ = A.shape
    H, _ = phessenberg_signed_core(jnp.asarray(A), S, want_q=False)
    Hn = np.asarray(H)
    rc, niter, out = native.pqz_real_gen_niter_cpu(Hn, S, want_z=True)
    assert rc == 0, f"rc={rc} after {niter} iterations (budget {120 * n})"
    assert niter <= 60 * n, f"{niter / n:.1f}n iterations"
    T, Z, alr, ali, be, sc = out
    scale = np.abs(Hn).max()
    for l in range(p):
        ln = (l + 1) % p
        R = (Z[l].T @ Hn[l] @ Z[ln]) if S[l] else (Z[ln].T @ Hn[l] @ Z[l])
        assert np.abs(R - T[l]).max() / scale < 1e3 * EPS * n, l
        assert np.abs(Z[l].T @ Z[l] - np.eye(n)).max() < 10 * EPS * n
