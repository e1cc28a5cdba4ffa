"""Smoke run of the periodic Schur library's main path on one NVIDIA GPU.

Drives the public API (``pschur``, ``gpschur``-style signed cycles,
``ordschur``, ``eigvecs``, ``partial_pschur``) once at the sizes users call
real, checks every result against the reference's accuracy contract and
against a plain reference on the same draw, and prints one JSON line:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (each line reports compile and run seconds apart, the iteration
count, the worst per-factor backward error and the orthogonality):

  1. device and card (``nvidia-smi`` name and power limit);
  2. real PSD, p=16 n=512, against the native C++ core on the host;
  3. complex GPSD, S=(T,F,T,F,T,F), p=6 n=128, against the CPU;
  4. real GPSD, same signature and size, against the CPU;
  5. ``ordschur`` and ``eigvecs`` on the phase-2 result, against the CPU;
  6. ``partial_pschur`` nev=4 at p=4 n=4096 on dense factors held on the
     device, against the CPU and the planted spectrum;
  7. ``backend="split"`` at p=4 n=64 against the complex128 core;
  and at p=4 n=32 the real and the signed complex decompositions against
  ``eigvals`` of the explicit product.

Tolerances, from the reference's contract (BASELINE.md):
  * backward error ||A_l - Z T Z'||_1 < 100 eps ||A_l||_1 per factor
    (``check_psd``'s default);
  * orthogonality ||Z Z' - I||_1 < 10 eps n (``check_psd``'s default);
  * eigenvalues within 1000 eps max|lambda| of eig(prod A) at p=4 n=32;
  * device against reference on the same draw: eigenvalues agree within
    1e-8 max|lambda| after nearest matching.  Both runs are backward
    stable, so they differ by about eps * cond * p * n; 1e-8 leaves room
    for eigenvalue condition numbers up to ~1e5 at n=512, p=16;
  * eigenvectors: ||A_l ... A_{l-1} x_l - lambda x_l|| < 1e-7 |lambda|
    ||x_l|| for every slot l (the repo's own ``ev_check`` bound);
  * Krylov Ritz values within 1e-6 |lambda| of the planted eigenvalues
    (residual tolerance sqrt(eps) times a modest condition number).

Usage:
    python chip_smoke.py              # one GPU, all phases
    python chip_smoke.py --four-gpus  # the multi-device paths on 4 GPUs,
                                      # each against the same call on one

Exits non-zero, and prints no JSON line, without a GPU or when any phase
or comparison fails.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

EPS = float(np.finfo(np.float64).eps)
RESIDUAL_TOL = 100.0
ORTH_TOL = 10.0
EIG_TOL = 1000.0
AGREE_TOL = 1e-8
EV_TOL = 1e-7
KRYLOV_TOL = 1e-6
SIG6 = (True, False, True, False, True, False)


def _psd():
    import periodicschurdecompositions_jax as psd
    return psd


def _ready(x):
    import jax
    return jax.block_until_ready(x)


def _timed(fn):
    t0 = time.perf_counter()
    out = _ready(fn())
    return out, time.perf_counter() - t0


def _counted(fn, kind, p, n):
    """Run ``fn`` with the library's progress reporting on; return its
    result and the iteration count that the ``[pschur <kind>] p= n=`` line
    reported (None if none).  The line is matched in full because a
    reference may run on the host at the same time."""
    psd = _psd()
    buf = io.StringIO()
    psd.setverbosity(1)
    try:
        with contextlib.redirect_stdout(buf):
            out = _ready(fn())
    finally:
        psd.setverbosity(0)
    its = re.findall(rf"\[pschur {kind}\] p={p} n={n}: (\d+) iterations",
                     buf.getvalue())
    return out, (int(its[-1]) if its else None)


def _cpu():
    import jax
    return jax.devices("cpu")[0]


def _on_cpu(fn):
    import jax
    with jax.default_device(_cpu()):
        return _ready(fn())


def _devices_of(*xs):
    out = set()
    for x in xs:
        if x is not None:
            out |= set(x.devices())
    return out


def match_error(a, b) -> float:
    """Largest distance between two eigenvalue multisets, pairing each
    value of ``a`` greedily with its nearest unused value of ``b``."""
    a = np.asarray(a, complex).ravel()
    rest = list(np.asarray(b, complex).ravel())
    if len(a) != len(rest):
        return float("inf")
    worst = 0.0
    for x in a[np.argsort(-np.abs(a))]:
        d = np.abs(np.asarray(rest) - x)
        j = int(np.argmin(d))
        worst = max(worst, float(d[j]))
        rest.pop(j)
    return worst


def _finite_values(P):
    v = np.asarray(P.values)
    return v[np.isfinite(v)]


def _check(rec, cond, what):
    if not cond:
        rec["ok"] = False
        rec.setdefault("failed", []).append(what)


def _contract(rec, P, A):
    """check_psd at the reference's default tolerances (worst so far)."""
    psd = _psd()
    ok, rep = psd.check_psd(P, A, qtol=ORTH_TOL, tol=RESIDUAL_TOL)
    rec["backerr"] = max(rec.get("backerr", 0.0), float(rep["residual_rel"]))
    rec["backerr_bound"] = RESIDUAL_TOL * EPS
    rec["orth"] = max(rec.get("orth", 0.0), float(rep["orthonormality"]))
    rec["orth_bound"] = float(rep["orthonormality_bound"])
    _check(rec, ok, "check_psd contract")


def _agree(rec, vals, ref_vals, name):
    vals = np.asarray(vals)
    scale = max(float(np.abs(ref_vals).max()), EPS)
    err = match_error(vals, ref_vals) / scale
    rec[f"agree_{name}"] = err
    _check(rec, err <= AGREE_TOL, f"eigenvalues vs {name}")


def _diag_cycle(p, n, dtype, seed):
    """A cycle that is already triangular: it compiles every program the
    real draw needs at the same shapes while its iteration only deflates."""
    r = np.random.default_rng(seed)
    d = r.uniform(1.0, 2.0, (p, n)).astype(dtype)
    return np.stack([np.diag(x) for x in d])


def _draw(p, n, seed, cplx=False):
    r = np.random.default_rng(seed)
    A = r.standard_normal((p, n, n))
    if cplx:
        A = A + 1j * r.standard_normal((p, n, n))
    return A


# ---------------------------------------------------------------------------
# phases


def phase_real(p=16, n=512, seed=0):
    """Real PSD through ``psd.pschur`` against the native C++ core."""
    import jax
    psd = _psd()
    from periodicschurdecompositions_jax import native
    rec = {"phase": f"real-psd p={p} n={n}", "ok": True}
    A = _draw(p, n, seed)
    Ad = jax.device_put(A)
    warm = jax.device_put(_diag_cycle(p, n, np.float64, seed + 1))
    _, rec["compile_s"] = _timed(
        lambda: _counted(lambda: psd.pschur(warm), "real", p, n))
    t0 = time.perf_counter()
    P, rec["iterations"] = _counted(lambda: psd.pschur(Ad), "real", p, n)
    rec["run_s"] = time.perf_counter() - t0
    dev = next(iter(Ad.devices()))
    _check(rec, _devices_of(P.Ts, P.Zs, P.values) == {dev},
           "results stay on the input's device")
    _contract(rec, P, A)
    rec["native_available"] = native.available()
    if rec["native_available"]:
        t0 = time.perf_counter()
        _, _, wr, wi = native.pschur_real_cpu(A, want_z=False)
        rec["ref_s"] = time.perf_counter() - t0
        _agree(rec, np.asarray(P.values), wr + 1j * wi, "native")
    else:
        _check(rec, False, "native reference unavailable")
    return rec, P, A


def gpsd_reference(p, n, S, seed, cplx):
    """The generalized phases' reference: the same public call on the same
    draw, pinned to the CPU.  Returns (finite eigenvalues, seconds)."""
    psd = _psd()
    A = _draw(p, n, seed, cplx)
    t0 = time.perf_counter()
    P = _on_cpu(lambda: psd.pschur(A, S=S))
    return _finite_values(P), time.perf_counter() - t0


def _phase_gpsd(name, cplx, ref, p, n, S, seed):
    import jax
    psd = _psd()
    rec = {"phase": f"{name} S={''.join('TF'[not s] for s in S)} p={p} "
                    f"n={n}", "ok": True}
    # the reference first: while it runs on the host, its progress line
    # would carry this phase's label
    ref_vals, rec["ref_s"] = (ref() if ref is not None else
                              gpsd_reference(p, n, S, seed, cplx))
    A = _draw(p, n, seed, cplx)
    Ad = jax.device_put(A)
    dt = np.complex128 if cplx else np.float64
    warm = jax.device_put(_diag_cycle(p, n, dt, seed + 1))
    kind = "complex" if cplx else "real gen"
    _, rec["compile_s"] = _timed(
        lambda: _counted(lambda: psd.pschur(warm, S=S), kind, p, n))
    t0 = time.perf_counter()
    P, rec["iterations"] = _counted(lambda: psd.pschur(Ad, S=S), kind, p, n)
    rec["run_s"] = time.perf_counter() - t0
    dev = next(iter(Ad.devices()))
    _check(rec, _devices_of(P.Ts, P.Zs, P.alpha, P.beta) == {dev},
           "results stay on the input's device")
    _contract(rec, P, A)
    _agree(rec, _finite_values(P), ref_vals, "cpu")
    return rec


COMPLEX_GPSD = dict(p=6, n=128, S=SIG6, seed=2)
REAL_GPSD = dict(p=6, n=128, S=SIG6, seed=3)


def phase_complex_gpsd(ref=None, **size):
    """Complex GPSD with a mixed signature against the CPU.  ``ref``, when
    given, returns the reference that :func:`gpsd_reference` computes."""
    return _phase_gpsd("complex-gpsd", True, ref, **dict(COMPLEX_GPSD, **size))


def phase_real_gpsd(ref=None, **size):
    """Real GPSD with a mixed signature against the CPU (see above)."""
    return _phase_gpsd("real-gpsd", False, ref, **dict(REAL_GPSD, **size))


def _ev_residual(A, Vs, lams):
    """Worst ||A_l A_{l+1} ... A_{l-1} x_l - lambda x_l|| / (|lambda| ||x_l||)
    over the slots l, applying the cyclic product factor by factor."""
    p = len(A)
    worst = 0.0
    for k, lam in enumerate(lams):
        for l in range(p):
            x = np.asarray(Vs[l])[:, k]
            y = x
            for m in reversed(range(p)):
                y = A[(l + m) % p] @ y
            worst = max(worst, float(np.linalg.norm(y - lam * x) /
                                     (abs(lam) * np.linalg.norm(x))))
    return worst


def _with_partners(vals, idx):
    """Indices ``idx`` widened over complex-conjugate partners (adjacent)."""
    out = set(idx)
    for j in idx:
        if vals[j].imag != 0:
            out.add(j + 1 if j + 1 < len(vals) and vals[j + 1] ==
                    np.conj(vals[j]) else j - 1)
    return sorted(out)


def phase_ordschur_eigvecs(P, A, k=4):
    """ordschur of the last k eigenvalues to the top, and eigvecs of the
    largest one, on a decomposition; both against the CPU."""
    import jax
    psd = _psd()
    n = P.n
    rec = {"phase": f"ordschur+eigvecs p={P.period} n={n}", "ok": True,
           "iterations": None}
    select = [j >= n - k for j in range(n)]
    _, first = _timed(lambda: psd.ordschur(P, select))
    P2, rec["run_s"] = _timed(lambda: psd.ordschur(P, select))
    rec["compile_s"] = max(first - rec["run_s"], 0.0)
    dev = next(iter(P.Ts.devices()))
    _check(rec, _devices_of(P2.Ts, P2.Zs, P2.values) == {dev},
           "ordschur result on the input's device")
    _contract(rec, P2, A)
    vals = np.asarray(P.values)
    chosen = _with_partners(vals, range(n - k, n))
    moved = np.asarray(P2.values)[:len(chosen)]
    scale = float(np.abs(vals).max())
    rec["moved_err"] = match_error(moved, vals[chosen]) / scale
    _check(rec, rec["moved_err"] <= AGREE_TOL, "selected values on top")
    Pc = jax.device_put(P, _cpu())
    P2c = _on_cpu(lambda: psd.ordschur(Pc, select))
    _agree(rec, np.asarray(P2.values), np.asarray(P2c.values), "cpu")

    # the largest eigenvalue, with its conjugate partner when it has one
    pick = _with_partners(vals, [int(np.argmax(np.abs(vals)))])
    sel = [i in pick for i in range(n)]
    t0 = time.perf_counter()
    Vs = _ready(psd.eigvecs(P, sel))
    rec["eigvecs_s"] = time.perf_counter() - t0
    _check(rec, _devices_of(*Vs) == {dev}, "eigvecs on the input's device")
    lams = vals[pick]
    rec["ev_residual"] = _ev_residual(A, Vs, lams)
    _check(rec, rec["ev_residual"] < EV_TOL, "eigenvector residual")
    Vc = _on_cpu(lambda: psd.eigvecs(Pc, sel))
    rec["ev_residual_cpu"] = _ev_residual(A, Vc, lams)
    _check(rec, rec["ev_residual_cpu"] < EV_TOL, "cpu eigenvector residual")
    return rec


def krylov_cycle(p, n, seed):
    """p factors Q T_l Q^T with a common orthogonal Q and upper-triangular
    T_l, made on the default device.  The product's eigenvalues are the
    products of the diagonals: the leading ones are planted well apart.
    Returns (A on the device, planted eigenvalues sorted by modulus)."""
    import jax
    import jax.numpy as jnp
    key = jax.random.PRNGKey(seed)
    kq, kt, kd = jax.random.split(key, 3)
    Q, _ = jnp.linalg.qr(jax.random.normal(kq, (n, n), jnp.float64))
    lead = 2.0 * 0.8 ** np.arange(8)
    d = np.empty((p, n))
    d[:, :8] = lead
    d[:, 8:] = np.asarray(jax.random.uniform(kd, (p, n - 8), jnp.float64,
                                             0.1, 1.0))
    noise = jax.random.normal(kt, (p, n, n), jnp.float64) * (0.01 / n ** 0.5)
    T = jnp.triu(noise, 1) + jnp.asarray(d)[:, :, None] * jnp.eye(n)
    A = jnp.einsum("ij,ljk,mk->lim", Q, T, Q)
    lams = np.prod(d, axis=0)
    return A, lams[np.argsort(-np.abs(lams))]


def phase_krylov(p=4, n=4096, nev=4, seed=5):
    """partial_pschur on dense factors held on the device, against the
    same call on the CPU and the planted spectrum."""
    import jax
    psd = _psd()
    rec = {"phase": f"partial_pschur nev={nev} p={p} n={n}", "ok": True}
    A, planted = krylov_cycle(p, n, seed)
    A = _ready(A)
    (PS, hist), first = _timed(lambda: psd.partial_pschur(A, nev))
    (PS, hist), rec["run_s"] = _timed(lambda: psd.partial_pschur(A, nev))
    rec["compile_s"] = max(first - rec["run_s"], 0.0)
    rec["iterations"] = int(hist.nprods)
    dev = next(iter(A.devices()))
    _check(rec, _devices_of(PS.Ts, PS.Vs, PS.values) == {dev},
           "results on the factors' device")
    _check(rec, hist.nconverged >= nev, "converged")
    vals = np.asarray(PS.values)[:nev]
    rec["planted_err"] = match_error(vals, planted[:nev]) / abs(planted[0])
    _check(rec, rec["planted_err"] <= KRYLOV_TOL, "Ritz values vs planted")
    Ac = np.asarray(A)
    PSc, hc = _on_cpu(lambda: psd.partial_pschur(Ac, nev))
    rec["cpu_err"] = match_error(vals, np.asarray(PSc.values)[:nev]) / abs(
        planted[0])
    _check(rec, rec["cpu_err"] <= KRYLOV_TOL, "Ritz values vs cpu")
    # orthonormal Ritz bases and the contract-style residuals
    V = np.asarray(PS.Vs)
    rec["orth"] = max(float(np.linalg.norm(V[l].conj().T @ V[l] -
                                           np.eye(V.shape[-1]), 1))
                      for l in range(p))
    rec["orth_bound"] = ORTH_TOL * EPS * n
    _check(rec, rec["orth"] < rec["orth_bound"], "Ritz basis orthogonality")
    rec["ritz_residual"] = float(np.max(np.asarray(PS.residuals)))
    return rec


def phase_split(p=4, n=64, seed=7):
    """backend="split" against the complex128 core on the same draw."""
    import jax
    psd = _psd()
    rec = {"phase": f"split-complex p={p} n={n}", "ok": True}
    A = _draw(p, n, seed, cplx=True)
    Ad = jax.device_put(A)
    warm = jax.device_put(_diag_cycle(p, n, np.complex128, seed + 1))
    _, rec["compile_s"] = _timed(lambda: _counted(
        lambda: psd.pschur(warm, backend="split"), "split", p, n))
    t0 = time.perf_counter()
    P, rec["iterations"] = _counted(
        lambda: psd.pschur(Ad, backend="split"), "split", p, n)
    rec["run_s"] = time.perf_counter() - t0
    _contract(rec, P, A)
    Pc = _ready(psd.pschur(Ad, backend="complex"))
    _agree(rec, np.asarray(P.values), np.asarray(Pc.values), "complex128")
    return rec


def phase_small_eigvals(p=4, n=32, seed=11):
    """Real PSD and signed complex GPSD against eig(prod A) at small size."""
    import jax
    psd = _psd()
    rec = {"phase": f"small vs eig(prod) p={p} n={n}", "ok": True,
           "iterations": None}
    S = tuple(l % 2 == 0 for l in range(p))
    t0 = time.perf_counter()
    worst = 0.0
    for cplx, sig in ((False, None), (True, S)):
        A = _draw(p, n, seed, cplx)
        P = _ready(psd.pschur(jax.device_put(A), S=sig))
        _contract(rec, P, A)
        M = np.eye(n, dtype=A.dtype)
        for l in range(p):
            M = M @ (A[l] if sig is None or sig[l] else np.linalg.inv(A[l]))
        w = np.linalg.eigvals(M)
        err = match_error(np.asarray(P.values), w) / np.abs(w).max()
        worst = max(worst, err)
    rec["run_s"] = time.perf_counter() - t0
    rec["compile_s"] = None
    rec["eig_err"] = worst
    rec["eig_bound"] = EIG_TOL * EPS
    _check(rec, worst <= EIG_TOL * EPS, "eigenvalues vs eig(prod)")
    return rec


# ---------------------------------------------------------------------------
# four devices


def _sharded_vs_single(rec, name, got, ref, tol):
    err = max(float(np.abs(np.asarray(g) - np.asarray(r)).max() /
                    max(np.abs(np.asarray(r)).max(), EPS))
              for g, r in zip(got, ref))
    rec[f"{name}_err"] = err
    _check(rec, err <= tol, f"{name}: four devices vs one")


def _lane(out, b, S):
    """Batch lane ``b`` of a batched core's output as a decomposition."""
    psd = _psd()
    x = [np.asarray(o[b]) for o in out]
    if S is None:
        T, Z, wr, wi = x[:4]
        return psd.PeriodicSchur(Ts=T, Zs=Z, values=wr + 1j * wi,
                                 orientation="R", schurindex=0)
    T, Z, alpha, beta, scale = x[:5]
    return psd.GeneralizedPeriodicSchur(
        S=S, schurindex=0, Ts=T, Zs=Z, alpha=alpha, beta=beta,
        alphascale=scale, orientation="R")


def _batch_vs_single(rec, name, A, got, ref, S=None):
    """Lane by lane: both decompositions meet the contract and their
    spectra agree.  The factors themselves are not compared: rounding may
    differ between the two programs and settle the blocks in another order.
    ``S`` marks a generalized (complex QZ) batch."""
    A = np.asarray(A)
    worst = 0.0
    for b in range(A.shape[0]):
        lane = []
        for out in (got, ref):
            P = _lane(out, b, S)
            _contract(rec, P, A[b])
            lane.append(np.asarray(P.values))
        worst = max(worst, match_error(*lane) / max(np.abs(lane[1]).max(),
                                                     EPS))
    rec[f"{name}_err"] = worst
    _check(rec, worst <= AGREE_TOL, f"{name}: four devices vs one")


def phase_four_devices(n_dev=4, batch=(4, 64), cx_batch=(4, 32), ring_n=2048,
                       krylov=(4, 4096), seed=13):
    """The public multi-device paths on ``n_dev`` devices, each against the
    same call on one device.  ``batch``/``cx_batch`` are the (p, n) of the
    real and complex problem batches (two problems per device),
    ``ring_n`` the factor size of the ring walk, ``krylov`` the (p, n) of
    the row-sharded Krylov cycle."""
    import jax.numpy as jnp
    from periodicschurdecompositions_jax.parallel.krylov_ops import (
        ShardedCycleOps, sharded_dense_ops)
    from periodicschurdecompositions_jax.parallel.mesh import (
        batched_pschur_complex, batched_pschur_real, make_mesh)
    from periodicschurdecompositions_jax.parallel.ring import (
        ring_cycle_products, ring_product_apply)
    psd = _psd()
    rec = {"phase": f"multi-device x{n_dev}", "ok": True, "iterations": None}
    r = np.random.default_rng(seed)
    t0 = time.perf_counter()

    # problem-batch sharding: one lane per device and one more round
    mesh_b = make_mesh(n_dev, names=("batch",))
    one_b = make_mesh(1, names=("batch",))
    B, (p, n) = 2 * n_dev, batch
    A = jnp.asarray(r.standard_normal((B, p, n, n)))
    got = _ready(batched_pschur_real(A, mesh=mesh_b))
    ref = _ready(batched_pschur_real(A, mesh=one_b))
    _check(rec, bool(np.all(np.asarray(got[4]))), "batched real converged")
    _batch_vs_single(rec, "batched_real", A, got, ref)
    pc, nc = cx_batch
    Ac = jnp.asarray(r.standard_normal((B, pc, nc, nc)) +
                     1j * r.standard_normal((B, pc, nc, nc)))
    S = tuple(l % 2 == 0 for l in range(pc))
    got = _ready(batched_pschur_complex(Ac, S, mesh=mesh_b))
    ref = _ready(batched_pschur_complex(Ac, S, mesh=one_b))
    _check(rec, bool(np.all(np.asarray(got[5]))), "batched complex converged")
    _batch_vs_single(rec, "batched_complex", Ac, got, ref, S)

    # factor-ring pipeline
    mesh_c = make_mesh(n_dev, names=("cycle",))
    one_c = make_mesh(1, names=("cycle",))
    pc, nr = 2 * n_dev, ring_n
    Ar = jnp.asarray(r.standard_normal((pc, nr, nr)) / nr ** 0.5)
    v = jnp.asarray(r.standard_normal((nr,)))
    got = _ready(ring_product_apply(Ar, v, mesh_c))
    ref = _ready(ring_product_apply(Ar, v, one_c))
    _sharded_vs_single(rec, "ring_product", [got], [ref], 1e-12)
    Vb = jnp.asarray(r.standard_normal((n_dev, nr, 4)))
    got = _ready(ring_cycle_products(Ar, Vb, mesh_c))
    # on one device block d is the same product started at factor dK
    K = pc // n_dev
    ref = [_ready(ring_cycle_products(jnp.roll(Ar, -d * K, axis=0),
                                      Vb[d:d + 1], one_c))[0]
           for d in range(n_dev)]
    _sharded_vs_single(rec, "ring_cycle", [got[d] for d in range(n_dev)],
                       ref, 1e-12)

    # row-sharded Krylov operators
    mesh_r = make_mesh(n_dev, names=("rows",))
    one_r = make_mesh(1, names=("rows",))
    Ak, planted = krylov_cycle(*krylov, seed)
    Ak = np.asarray(Ak)
    vals = {}
    for tag, mesh in (("x%d" % n_dev, mesh_r), ("x1", one_r)):
        ps, hist = psd.partial_pschur(ShardedCycleOps(Ak, mesh), 4)
        _check(rec, hist.nconverged >= 4, f"ShardedCycleOps {tag} converged")
        vals[tag] = np.asarray(ps.values)[:4]
        ops, n_out, dt = sharded_dense_ops(Ak, mesh)
        ps2, h2 = psd.partial_pschur(ops, 4, n=n_out, dtype=dt)
        _check(rec, h2.nconverged >= 4, f"sharded_dense_ops {tag} converged")
        vals[tag + "_dense"] = np.asarray(ps2.values)[:4]
    for tag, vv in vals.items():
        err = match_error(vv, planted[:4]) / abs(planted[0])
        rec[f"krylov_{tag}_err"] = err
        _check(rec, err <= KRYLOV_TOL, f"Krylov {tag} vs planted")
    rec["run_s"] = time.perf_counter() - t0
    rec["compile_s"] = None
    return rec


# ---------------------------------------------------------------------------
# driver


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of every card, one per line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def _fmt(x):
    if x is None:
        return "n/a"
    if isinstance(x, float):
        return f"{x:.3e}" if (x and (abs(x) < 1e-2 or abs(x) >= 1e4)) \
            else f"{x:.3f}"
    return str(x)


def report(rec):
    keys = [k for k in rec if k not in ("phase", "ok", "failed")]
    body = ", ".join(f"{k}={_fmt(rec[k])}" for k in keys)
    status = "OK" if rec["ok"] else "FAIL " + "; ".join(rec.get("failed",
                                                                 []))
    print(f"[{rec['phase']}] {body} -> {status}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the multi-device paths on four GPUs")
    args = ap.parse_args(argv)
    import jax
    devs = jax.devices()
    print("devices:", devs, flush=True)
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default platform is {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.four_gpus else 1
    if len(devs) < want:
        print(f"need {want} GPUs, have {len(devs)}", file=sys.stderr)
        return 2
    print("card:", card_line(), flush=True)
    _psd()
    if args.four_gpus:
        recs = [phase_four_devices(4)]
        report(recs[0])
    else:
        # the generalized phases' CPU references run on the host while the
        # card works on phase 2
        with ThreadPoolExecutor(max_workers=1) as pool:
            ref_cx = pool.submit(gpsd_reference, cplx=True, **COMPLEX_GPSD)
            ref_rg = pool.submit(gpsd_reference, cplx=False, **REAL_GPSD)
            rec, P, A = phase_real()
            report(rec)
            recs = [rec]
            for fn in (lambda: phase_complex_gpsd(ref=ref_cx.result),
                       lambda: phase_real_gpsd(ref=ref_rg.result),
                       lambda: phase_ordschur_eigvecs(P, A), phase_krylov,
                       phase_split, phase_small_eigvals):
                recs.append(fn())
                report(recs[-1])
    if not all(r["ok"] for r in recs):
        print("smoke FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
