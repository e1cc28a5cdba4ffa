"""End-to-end tests for the complex periodic QZ core.

Mirrors the reference oracles (test/testfuncs.jl): triangularity,
orthonormality, per-factor reconstruction residual, and eigenvalues versus
numpy's eigvals of the explicit (signed) product.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.ops.hessenberg import phessenberg_core
from periodicschurdecompositions_jax.ops.pqz_complex import pqz_complex_core

EPS = np.finfo(np.float64).eps


def _rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _signed_prod(A, S):
    p = len(S)
    M = np.eye(A.shape[1], dtype=complex)
    for l in range(p):
        M = M @ (A[l] if S[l] else np.linalg.inv(A[l]))
    return M


def run_and_check(A, S, check_vals=True, vals_tol=1000, res_tol=100):
    """Full pipeline: reduce to Hess/triangular then iterate; verify."""
    A = np.asarray(A)
    p, n, _ = A.shape
    if all(S):
        H, Q = phessenberg_core(jnp.asarray(A))
    else:
        from periodicschurdecompositions_jax.ops.hessenberg import (
            phessenberg_signed_core)
        H, Q = phessenberg_signed_core(jnp.asarray(A), S)
    T, Z, al, be, sc, ok = pqz_complex_core(H, S, Z=Q)
    assert bool(ok), "iteration did not converge"
    T = np.asarray(T)
    Z = np.asarray(Z)
    # triangularity
    for l in range(p):
        assert np.abs(np.tril(T[l], -1)).max() == 0.0, f"factor {l} not triangular"
    # orthonormality
    for l in range(p):
        assert np.abs(Z[l] @ Z[l].conj().T - np.eye(n)).max() < 20 * EPS * n
    # reconstruction
    for l in range(p):
        ln = (l + 1) % p
        if S[l]:
            Ax = Z[l] @ T[l] @ Z[ln].conj().T
        else:
            Ax = Z[ln] @ T[l] @ Z[l].conj().T
        scale = max(1.0, np.abs(A[l]).max())
        assert np.abs(Ax - A[l]).max() < res_tol * EPS * n * scale, (
            f"factor {l} residual {np.abs(Ax - A[l]).max() / (EPS * n * scale)}")
    # eigenvalues vs product (match as multisets sorted by abs, then angle)
    if check_vals:
        vals = np.asarray(al) / np.asarray(be) * np.exp2(
            np.asarray(sc).astype(np.float64))
        w = np.linalg.eigvals(_signed_prod(A, S))
        vs = sorted(vals, key=lambda z: (abs(z), np.angle(z)))
        ws = sorted(w, key=lambda z: (abs(z), np.angle(z)))
        scale = max(np.abs(w).max(), 1e-300)
        err = max(abs(a - b) for a, b in zip(vs, ws))
        assert err < vals_tol * EPS * scale * n, f"eigval err {err/(EPS*scale)} eps"
    return T, Z, np.asarray(al), np.asarray(be), np.asarray(sc)


class TestComplexPSD:
    """All-positive signature = plain complex periodic Schur."""

    @pytest.mark.parametrize("p,n", [(1, 8), (2, 8), (3, 7), (5, 6), (4, 32)])
    def test_random(self, rng, p, n):
        A = _rand_c(rng, p, n, n)
        run_and_check(A, (True,) * p)

    def test_presplit_input(self, rng):
        # Hessenberg with an exact zero subdiagonal: exercises test-1 deflation
        p, n = 3, 8
        A = _rand_c(rng, p, n, n)
        H, Q = phessenberg_core(jnp.asarray(A))
        H = np.asarray(H).copy()
        H[0][4, 3] = 0.0
        T, Z, al, be, sc, ok = pqz_complex_core(jnp.asarray(H), (True,) * p, Z=Q)
        assert bool(ok)

    def test_long_cycle_scaling(self, rng):
        # p=25 > 19: permanent controlled-zero-shift mode (ziter = -1);
        # eigenvalue magnitudes span 2^±large, exercising scaled products
        p, n = 25, 4
        A = _rand_c(rng, p, n, n) * 0.1
        run_and_check(A, (True,) * p, vals_tol=1e5)

    def test_n1(self, rng):
        A = _rand_c(rng, 3, 1, 1)
        T, Z, al, be, sc, ok = pqz_complex_core(jnp.asarray(A), (True, True, True))
        assert bool(ok)
        v = complex((np.asarray(al) / np.asarray(be) * 2.0 ** np.asarray(sc))[0])
        assert abs(v - complex(np.asarray(A[0] @ A[1] @ A[2])[0, 0])) < 1e-13


class TestComplexGPSDHessInput:
    """Mixed signatures on pre-reduced (Hessenberg + triangular) inputs."""

    def _hess_tri(self, rng, p, n, S):
        # build a Hess/triangular cycle directly (reference 'easy input' style)
        H = np.zeros((p, n, n), complex)
        H[0] = np.triu(_rand_c(rng, n, n), -1)
        for l in range(1, p):
            H[l] = np.triu(_rand_c(rng, n, n)) + 2 * np.eye(n)
        return H

    @pytest.mark.parametrize("S", [(True, False), (True, True, False),
                                   (True, False, True, False)])
    def test_mixed(self, rng, S):
        p, n = len(S), 8
        H = self._hess_tri(rng, p, n, S)
        T, Z, al, be, sc, ok = pqz_complex_core(jnp.asarray(H), S)
        assert bool(ok)
        T2, Z2 = np.asarray(T), np.asarray(Z)
        for l in range(p):
            assert np.abs(np.tril(T2[l], -1)).max() == 0.0
            ln = (l + 1) % p
            if S[l]:
                Ax = Z2[l] @ T2[l] @ Z2[ln].conj().T
            else:
                Ax = Z2[ln] @ T2[l] @ Z2[l].conj().T
            assert np.abs(Ax - H[l]).max() < 200 * EPS * n * max(
                1, np.abs(H[l]).max())
        vals = np.asarray(al) / np.asarray(be) * np.exp2(np.asarray(sc).astype(float))
        w = np.linalg.eigvals(_signed_prod(H, S))
        vs = sorted(vals, key=lambda z: (abs(z), np.angle(z)))
        ws = sorted(w, key=lambda z: (abs(z), np.angle(z)))
        scale = np.abs(w).max()
        assert max(abs(a - b) for a, b in zip(vs, ws)) < 1e4 * EPS * scale * n

    def test_planted_hole_pos(self, rng):
        # zero diagonal entry in a NON-inverted factor: infinite-free case,
        # one zero eigenvalue; exercises DEFLATE_POS
        p, n = 3, 8
        S = (True, True, False)
        H = self._hess_tri(rng, p, n, S)
        for hole in [0, 3, n - 1]:
            Hh = H.copy()
            Hh[1][hole, hole] = 0.0
            T, Z, al, be, sc, ok = pqz_complex_core(jnp.asarray(Hh), S)
            assert bool(ok), f"hole at {hole} did not converge"
            vals = np.asarray(al) / np.asarray(be) * np.exp2(
                np.asarray(sc).astype(float))
            # exactly one zero eigenvalue
            assert (np.abs(vals) == 0.0).sum() == 1, f"hole {hole}: {vals}"
            T2, Z2 = np.asarray(T), np.asarray(Z)
            for l in range(p):
                ln = (l + 1) % p
                Ax = (Z2[l] @ T2[l] @ Z2[ln].conj().T if S[l]
                      else Z2[ln] @ T2[l] @ Z2[l].conj().T)
                assert np.abs(Ax - Hh[l]).max() < 500 * EPS * n * max(
                    1, np.abs(Hh[l]).max()), f"hole {hole} factor {l}"

    def test_planted_hole_neg(self, rng):
        # zero diagonal in an INVERTED factor -> one infinite eigenvalue;
        # exercises DEFLATE_NEG (both chase directions via hole position)
        p, n = 3, 8
        S = (True, True, False)
        H = self._hess_tri(rng, p, n, S)
        for hole in [0, 2, 5, n - 1]:
            Hh = H.copy()
            Hh[2][hole, hole] = 0.0
            T, Z, al, be, sc, ok = pqz_complex_core(jnp.asarray(Hh), S)
            assert bool(ok), f"hole at {hole} did not converge"
            be2 = np.asarray(be)
            assert (be2 == 0.0).sum() == 1, f"hole {hole}: beta={be2}"
            T2, Z2 = np.asarray(T), np.asarray(Z)
            for l in range(p):
                ln = (l + 1) % p
                Ax = (Z2[l] @ T2[l] @ Z2[ln].conj().T if S[l]
                      else Z2[ln] @ T2[l] @ Z2[l].conj().T)
                assert np.abs(Ax - Hh[l]).max() < 500 * EPS * n * max(
                    1, np.abs(Hh[l]).max()), f"hole {hole} factor {l}"
