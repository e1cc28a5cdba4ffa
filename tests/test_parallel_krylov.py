"""Row-sharded Krylov operators over the virtual device mesh (SURVEY §2
parallel axis (c): intra-matrix sharding)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jax.parallel.krylov_ops import (
    sharded_dense_ops)
from periodicschurdecompositions_jax.parallel.mesh import make_mesh
from periodicschurdecompositions_jax.models.krylov import partial_pschur


@pytest.mark.skipif(len(jax.devices("cpu")) < 8,
                    reason="needs the 8-device virtual CPU mesh")
def test_sharded_matvec_matches_dense(rng):
    mesh = make_mesh(8, names=("rows",))
    p, n = 3, 64
    A = rng.standard_normal((p, n, n))
    ops, n_out, dt = sharded_dense_ops(A, mesh)
    assert n_out == n
    v = rng.standard_normal(n)
    for l in range(p):
        got = np.asarray(ops[l](v))
        assert np.allclose(got, A[l] @ v, atol=1e-12)


@pytest.mark.skipif(len(jax.devices("cpu")) < 8,
                    reason="needs the 8-device virtual CPU mesh")
def test_sharded_partial_pschur(rng):
    """partial_pschur over row-sharded factors reproduces the dense run."""
    mesh = make_mesh(8, names=("rows",))
    p, n = 2, 96
    # well-spread spectrum so LM converges fast
    A = []
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    for l in range(p):
        T = np.triu(rng.standard_normal((n, n)) * 0.05)
        np.fill_diagonal(T, 1.15 ** np.arange(n))
        A.append(q @ T @ q.T)
    A = np.stack(A)
    ops, n_out, dt = sharded_dense_ops(A, mesh)
    ps_sh, hist_sh = partial_pschur(ops, 4, "LM", n=n, dtype=dt)
    ps_d, hist_d = partial_pschur(jnp.asarray(A), 4, "LM")
    assert hist_sh.nconverged >= 4
    v1 = np.sort(np.abs(np.asarray(ps_sh.values)))[-4:]
    v2 = np.sort(np.abs(np.asarray(ps_d.values)))[-4:]
    assert np.allclose(v1, v2, rtol=1e-6)


@pytest.mark.skipif(len(jax.devices("cpu")) < 8,
                    reason="needs the 8-device virtual CPU mesh")
def test_device_resident_partial_pschur(rng):
    """Device-resident path (ShardedCycleOps): no host round-trip per
    matvec — the Arnoldi basis lives on the mesh and matvec+CGS run as one
    jitted program.  Must reproduce the dense run's Ritz values and the
    partial-decomposition residual."""
    from periodicschurdecompositions_jax.parallel.krylov_ops import (
        ShardedCycleOps)
    mesh = make_mesh(8, names=("rows",))
    p, n = 2, 96
    A = []
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    for l in range(p):
        T = np.triu(rng.standard_normal((n, n)) * 0.05)
        np.fill_diagonal(T, 1.15 ** np.arange(n))
        A.append(q @ T @ q.T)
    A = np.stack(A)
    sops = ShardedCycleOps(A, mesh)
    ps_sh, hist_sh = partial_pschur(sops, 4, "LM")
    assert hist_sh.nconverged >= 4
    ps_d, hist_d = partial_pschur(jnp.asarray(A), 4, "LM")
    v1 = np.sort(np.abs(np.asarray(ps_sh.values)))[-4:]
    v2 = np.sort(np.abs(np.asarray(ps_d.values)))[-4:]
    assert np.allclose(v1, v2, rtol=1e-6)
    # partial decomposition residual: A[l] V[l] = V[l+1] T[l]
    V = np.asarray(ps_sh.Vs)
    T = np.asarray(ps_sh.Ts)
    k = V.shape[2]
    for l in range(p):
        R = A[l] @ V[l] - V[(l + 1) % p] @ T[l]
        assert np.abs(R).max() < 1e-7, (l, np.abs(R).max())
