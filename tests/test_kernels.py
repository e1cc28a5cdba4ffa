"""Unit tests for the L0 kernel layer: Givens, Householder, dlanv2, safeprod."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.ops import rotations as rot
from periodicschurdecompositions_jax.ops import householder as hh
from periodicschurdecompositions_jax.ops.lanv2 import lanv2
from periodicschurdecompositions_jax.utils.safeprod import safeprod_signed


EPS = np.finfo(np.float64).eps


class TestGivens:
    def test_real_basic(self, rng):
        for _ in range(50):
            f, g = rng.standard_normal(2)
            c, s, r = jax.jit(rot.givens_real)(f, g)
            c, s, r = float(c), float(s), float(r)
            assert abs(c * f + s * g - r) < 10 * EPS * max(abs(f), abs(g))
            assert abs(-s * f + c * g) < 10 * EPS * max(abs(f), abs(g))
            assert abs(c * c + s * s - 1) < 10 * EPS
            assert c >= 0

    def test_real_zeros(self):
        c, s, r = rot.givens_real(3.0, 0.0)
        assert (float(c), float(s), float(r)) == (1.0, 0.0, 3.0)
        c, s, r = rot.givens_real(0.0, -2.0)
        assert (float(c), float(s), float(r)) == (0.0, -1.0, 2.0)
        c, s, r = rot.givens_real(0.0, 0.0)
        assert (float(c), float(s), float(r)) == (1.0, 0.0, 0.0)

    def test_real_extreme_scales(self):
        for scale in [1e-300, 1e300, 1e-160]:
            f, g = 3.0 * scale, -4.0 * scale
            c, s, r = rot.givens_real(f, g)
            assert np.isfinite(float(r))
            assert abs(float(c) * f + float(s) * g - float(r)) < 1e-10 * abs(scale) * 10

    def test_complex_basic(self, rng):
        for _ in range(50):
            f = complex(*rng.standard_normal(2))
            g = complex(*rng.standard_normal(2))
            c, s, r = jax.jit(rot.givens_complex)(f, g)
            c, s, r = complex(c), complex(s), complex(r)
            assert abs(c.imag) == 0.0
            assert abs(c * f + s * g - r) < 20 * EPS
            assert abs(-np.conj(s) * f + c * g) < 20 * EPS
            assert abs(abs(c) ** 2 + abs(s) ** 2 - 1) < 20 * EPS

    def test_complex_zeros(self):
        c, s, r = rot.givens_complex(1 + 2j, 0.0)
        assert complex(s) == 0 and complex(r) == 1 + 2j and float(c.real) == 1.0
        c, s, r = rot.givens_complex(0.0, 3 + 4j)
        assert float(c.real) == 0.0
        assert abs(complex(r) - 5.0) < 20 * EPS
        assert abs(complex(s) - (3 - 4j) / 5) < 20 * EPS


class TestPairApply:
    def test_rows_cols_roundtrip(self, rng):
        H = jnp.asarray(rng.standard_normal((6, 6)))
        c, s, _ = rot.givens_real(H[2, 1], H[3, 1])
        M = rot.lmat(c, s)
        H2 = rot.rowsk(H, 2, M)
        # rotation annihilates H[3,1]
        assert abs(float(H2[3, 1])) < 1e-14
        # applying the adjoint from the right restores similarity
        H3 = rot.colsk(H2, 2, rot.rmat_adj(c, s))
        w0 = np.sort(np.linalg.eigvals(np.asarray(H)))
        w1 = np.sort(np.linalg.eigvals(np.asarray(H3)))
        assert np.allclose(w0, w1, atol=1e-12)

    def test_window_mask(self, rng):
        H = jnp.asarray(rng.standard_normal((6, 6)))
        M = rot.lmat(*rot.givens_real(1.0, 1.0)[:2])
        H2 = rot.rowsk(H, 1, M, lo=2, hi=5)
        assert np.allclose(np.asarray(H2[:, :2]), np.asarray(H[:, :2]))
        assert np.allclose(np.asarray(H2[:, 5:]), np.asarray(H[:, 5:]))
        assert not np.allclose(np.asarray(H2[1:3, 2:5]), np.asarray(H[1:3, 2:5]))

    def test_inactive_noop(self, rng):
        H = jnp.asarray(rng.standard_normal((6, 6)))
        M = rot.lmat(*rot.givens_real(1.0, 1.0)[:2])
        H2 = rot.rowsk(H, 99, M, active=jnp.asarray(False))
        assert np.array_equal(np.asarray(H2), np.asarray(H))


class TestReflector:
    @pytest.mark.parametrize("dtype", [np.float64, np.complex128])
    def test_masked_annihilates(self, rng, dtype):
        n = 12
        x = rng.standard_normal(n).astype(dtype)
        if np.iscomplexobj(x):
            x = x + 1j * rng.standard_normal(n)
        for lo in [0, 3, n - 2]:
            w, tau, beta = hh.reflector_masked(jnp.asarray(x), lo)
            # LAPACK convention: H^H @ x = beta e1, i.e. (I - conj(tau) w w^H)
            P = np.eye(n) - np.conj(np.asarray(tau)) * np.outer(
                np.asarray(w), np.conj(np.asarray(w)))
            y = P @ x
            assert abs(y[lo] - np.asarray(beta)) < 1e-13 * max(1, np.abs(x).max())
            assert np.abs(y[lo + 1:]).max() < 1e-13 * max(1, np.abs(x).max())
            if lo > 0:
                assert np.abs(y[:lo] - x[:lo]).max() == 0.0
            # unitarity of P
            assert np.abs(P @ P.conj().T - np.eye(n)).max() < 1e-13

    def test_trivial_tail(self):
        x = jnp.asarray([2.0, 0.0, 0.0, 0.0])
        w, tau, beta = hh.reflector_masked(x, 0)
        assert float(tau) == 0.0 and float(beta) == 2.0

    def test_underflow_rescue(self):
        # normal numbers below the sfmin (~2e-292) rescue threshold; XLA
        # flushes subnormals to zero so the sub-tiny range is untestable
        x = jnp.asarray([3e-305, 4e-305, 0.0])
        w, tau, beta = hh.reflector_small(x)
        assert np.isfinite(np.asarray(w)).all()
        assert abs(float(beta) + 5e-305) < 1e-318
        P = hh.refl_mat(np.asarray(w), np.asarray(tau))
        y = P @ np.asarray(x)
        assert abs(y[1]) / abs(float(beta)) < 1e-12

    def test_small_3(self, rng):
        v = rng.standard_normal(3)
        w, tau, beta = hh.reflector_small(jnp.asarray(v))
        P = hh.refl_mat(np.asarray(w), np.asarray(tau))
        y = P @ v
        assert abs(abs(y[0]) - np.linalg.norm(v)) < 1e-13
        assert np.abs(y[1:]).max() < 1e-13

    def test_full_apply(self, rng):
        A = rng.standard_normal((8, 8))
        w, tau, beta = hh.reflector_masked(jnp.asarray(A[:, 0]), 2)
        A2 = np.asarray(hh.refl_left(jnp.asarray(A), w, jnp.conj(tau)))
        assert np.abs(A2[3:, 0]).max() < 1e-13
        assert abs(A2[2, 0] - float(beta)) < 1e-13


class TestLanv2:
    def _check(self, a0, b0, c0, d0):
        a, b, c, d, cs, sn, w1r, w1i, w2r, w2i = (
            np.asarray(v) for v in lanv2(a0, b0, c0, d0))
        w1 = w1r + 1j * w1i
        w2 = w2r + 1j * w2i
        G = np.array([[cs, sn], [-sn, cs]], dtype=float)
        assert abs(cs**2 + sn**2 - 1) < 1e-14
        M0 = np.array([[a0, b0], [c0, d0]], dtype=float)
        M1 = G @ M0 @ G.T
        assert np.abs(M1 - np.array([[a, b], [c, d]])).max() < 1e-12 * max(
            1, np.abs(M0).max()
        )
        # standard form
        if c != 0:
            assert abs(a - d) < 1e-12 * max(1, abs(a))
            assert b * c < 0
        ws = np.sort_complex(np.linalg.eigvals(M0))
        wn = np.sort_complex(np.array([complex(w1), complex(w2)]))
        assert np.abs(ws - wn).max() < 1e-7 * max(1, np.abs(ws).max())

    def test_random(self, rng):
        for _ in range(200):
            self._check(*rng.standard_normal(4))

    def test_branches(self):
        self._check(1.0, 2.0, 0.0, 3.0)     # c == 0
        self._check(1.0, 0.0, 2.0, 3.0)     # b == 0
        self._check(2.0, 5.0, -3.0, 2.0)    # a == d, b*c < 0
        self._check(2.0, 1e-20, 1e-20, 2.0) # nearly equal
        self._check(1.0, 100.0, 1e-8, 1.0)  # tiny c


class TestSafeprod:
    def test_plain(self, rng):
        x = jnp.asarray(rng.standard_normal(7))
        a, b, s = safeprod_signed(x, (True,) * 7)
        val = float(a) * 2.0 ** int(s) / float(b)
        assert abs(val - np.prod(np.asarray(x))) < 1e-12 * abs(np.prod(np.asarray(x)))
        assert 1 <= abs(float(a)) < 2

    def test_signed(self, rng):
        x = np.abs(rng.standard_normal(6)) + 0.5
        S = (True, False, True, True, False, True)
        a, b, s = safeprod_signed(jnp.asarray(x), S)
        expect = np.prod([xi if Si else 1 / xi for xi, Si in zip(x, S)])
        val = float(a) * 2.0 ** int(s) / float(b)
        assert abs(val - expect) < 1e-12 * abs(expect)

    def test_huge_underflow_range(self):
        # product of 600 copies of 0.1 underflows naively; scaled form is exact
        x = jnp.full((600,), 0.1)
        a, b, s = safeprod_signed(x, (True,) * 600)
        log2val = np.log2(abs(float(a))) + int(s)
        assert abs(log2val - 600 * np.log2(0.1)) < 1e-6
        assert float(b) == 1.0

    def test_infinite(self):
        x = jnp.asarray([2.0, 0.0, 3.0])
        a, b, s = safeprod_signed(x, (True, False, True))
        assert float(b) == 0.0
        val = np.asarray(a) / np.asarray(b)
        assert np.isinf(val)

    def test_zero_over_zero(self):
        x = jnp.asarray([0.0, 0.0, 3.0])
        a, b, s = safeprod_signed(x, (True, False, True))
        assert float(b) == 0.0 and abs(complex(np.asarray(a))) == 0.0
