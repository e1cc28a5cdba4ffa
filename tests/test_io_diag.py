"""Checkpoint round-trip and FacChecker tests."""
import numpy as np
import jax.numpy as jnp

from periodicschurdecompositions_jax.models.drivers import pschur
from periodicschurdecompositions_jax.utils.io import (
    load_decomposition, save_decomposition)
from periodicschurdecompositions_jax.diagnostics import FacChecker


def test_save_load_roundtrip(rng, tmp_path):
    A = rng.standard_normal((3, 6, 6))
    P = pschur(jnp.asarray(A))
    f = str(tmp_path / "psd.npz")
    save_decomposition(f, P)
    P2 = load_decomposition(f)
    assert np.allclose(np.asarray(P.Ts), np.asarray(P2.Ts))
    assert np.allclose(np.asarray(P.Zs), np.asarray(P2.Zs))
    assert np.allclose(np.asarray(P.values), np.asarray(P2.values))
    assert P2.orientation == P.orientation and P2.schurindex == P.schurindex


def test_save_load_generalized(rng, tmp_path):
    A = rng.standard_normal((2, 5, 5)) + 3 * np.eye(5)
    P = pschur(jnp.asarray(A), "R", S=(True, False))
    f = str(tmp_path / "gpsd.npz")
    save_decomposition(f, P)
    P2 = load_decomposition(f)
    assert P2.S == P.S
    assert np.allclose(np.asarray(P.values), np.asarray(P2.values))


def test_facchecker(rng):
    A = rng.standard_normal((3, 6, 6))
    P = pschur(jnp.asarray(A))
    fc = FacChecker(A)
    drift = fc("after pschur", np.asarray(P.Ts), np.asarray(P.Zs),
               verbose=False)
    assert drift < 1e-13
    # corrupting Z must be detected
    Zbad = np.asarray(P.Zs).copy()
    Zbad[0, 0, 0] += 1e-3
    assert fc("corrupt", np.asarray(P.Ts), Zbad, verbose=False) > 1e-5


def test_krylov_checkpoint_resume(rng, tmp_path):
    """An interrupted partial_pschur resumes from its checkpoint and lands
    on the SAME result as an uninterrupted run (deterministic loop + saved
    RNG state)."""
    from periodicschurdecompositions_jax import partial_pschur

    p, n = 3, 40
    A = jnp.asarray(rng.standard_normal((p, n, n)))
    kw = dict(nev=3, which="LM", mindim=6, maxdim=12, seed=7)
    ref, href = partial_pschur(A, **kw)

    f = str(tmp_path / "krylov.npz")
    # interrupted run: stop after 2 restarts, checkpoint each
    partial_pschur(A, restarts=2, checkpoint=f, **kw)
    import os
    assert os.path.exists(f)
    # resumed run must complete and match the uninterrupted result
    got, hgot = partial_pschur(A, checkpoint=f, **kw)
    assert hgot.converged
    a = np.sort_complex(np.asarray(ref.values))
    b = np.sort_complex(np.asarray(got.values))
    assert np.allclose(a, b, rtol=1e-10, atol=1e-12)
    # shape mismatch must be rejected
    import pytest as _pytest
    A2 = jnp.asarray(np.asarray(A)[:, :n - 2, :n - 2])
    with _pytest.raises(ValueError):
        partial_pschur(A2, checkpoint=f, **kw)
