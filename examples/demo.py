"""End-to-end tour of the periodic Schur library.

Run:  python examples/demo.py   (on JAX's default device: CPU or GPU)
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

import periodicschurdecompositions_jax as psd

rng = np.random.default_rng(42)
p, n = 6, 24
A = jnp.asarray(rng.standard_normal((p, n, n)))

# --- periodic Schur decomposition: eigenvalues of A[0] @ ... @ A[5] --------
P = psd.pschur(A, "R")
ok, report = psd.check_psd(P, np.asarray(A))
print(f"pschur: p={p} n={n}  verified={ok}  "
      f"residual={report['residual_rel']:.2e}")
w_direct = np.linalg.eigvals(np.linalg.multi_dot(list(np.asarray(A))))
print("  |eig| range:", f"{np.abs(w_direct).min():.2e}",
      "to", f"{np.abs(w_direct).max():.2e}",
      " (never formed inside pschur)")

# --- reorder the 4 largest eigenvalues to the top --------------------------
vals = np.asarray(P.values)
sel = np.abs(vals) >= sorted(np.abs(vals))[-4]
P2 = psd.ordschur(P, list(sel))
print("ordschur: top-4 |values| now lead:",
      np.round(np.abs(np.asarray(P2.values))[:4], 3))

# --- eigenvectors of the product -------------------------------------------
V = psd.eigvecs(P, list(sel))
v = np.asarray(V[0])[:, 0]
lam = vals[sel][0]
prod = np.linalg.multi_dot(list(np.asarray(A)))
print(f"eigvecs: ||prod @ v - lambda v|| = "
      f"{np.linalg.norm(prod @ v - lam * v):.2e}")

# --- generalized decomposition of a quotient product -----------------------
S = (True, False, True, False)
B = jnp.asarray(rng.standard_normal((4, 12, 12)) + 3 * np.eye(12))
G = psd.pschur(B, "R", S=S)
okg, _ = psd.check_psd(G, np.asarray(B))
print(f"generalized pschur (S={S}): verified={okg}; eigenvalues stored as "
      f"alpha/beta*2^scale")

# --- large problem, matrix-free: periodic Krylov-Schur ---------------------
N = 5000
d = [0.5 + rng.random(N) for _ in range(3)]
for dd in d:
    dd[:4] += [3.0, 2.5, 2.0, 1.7]
ops = [lambda x, dd=dd: dd * x for dd in d]
ps, hist = psd.partial_pschur(ops, 4, "LM", n=N, dtype=np.float64)
print(f"partial_pschur: N={N} matrix-free; converged "
      f"{hist.nconverged}/{hist.nev} with {hist.nprods} operator applications")
print("  leading |values|:", np.round(np.abs(np.asarray(ps.values))[:4], 4))

# --- checkpoint round-trip ---------------------------------------------------
path = os.path.join(tempfile.mkdtemp(), "psd_demo.npz")
psd.save_decomposition(path, P2)
P3 = psd.load_decomposition(path)
print("save/load round-trip:",
      bool(np.allclose(np.asarray(P2.Ts), np.asarray(P3.Ts))))

# --- more features -----------------------------------------------------------
# split-complex backend: the QZ iteration on (re, im) float64 pairs
Ac = jnp.asarray(rng.standard_normal((3, 8, 8)) +
                 1j * rng.standard_normal((3, 8, 8)))
Pc = psd.pschur(Ac, "R", backend="split")   # "auto" runs complex128
okc, _ = psd.check_psd(Pc, np.asarray(Ac))
print(f"split-complex backend: verified={okc}")

# aggressive deflation thresholds for the real generalized decomposition
Gagg = psd.pschur(B, "R", S=S, aggressive=True)
print("aggressive deflation: verified=",
      psd.check_psd(Gagg, np.asarray(B))[0])

# native C++ host backend (exact f64; also the bench baseline)
from periodicschurdecompositions_jax import native
if native.available():
    Tn, Zn, wr, wi = native.pschur_real_cpu(np.asarray(A))
    wn = np.sort(np.abs(wr + 1j * wi))
    wj = np.sort(np.abs(vals))
    print(f"native C++ backend: max |lambda| diff vs JAX core = "
          f"{np.abs(wn - wj).max():.2e}")

# iteration counters at verbosity >= 1
psd.setverbosity(1)
_ = psd.pschur(A, "R", want_t=False, want_z=False)
psd.setverbosity(0)

# arbitrary-precision host path (the reference's BigFloat analogue)
from mpmath import mp
Pm = psd.pschur_mp(np.asarray(A)[:2, :6, :6], dps=40)
with mp.workdps(40):
    An6 = np.asarray(A)[:2, :6, :6]
    worst = max(
        abs(sum(Pm.Zs[l][i, k] * Pm.Ts[l][k, q] *
                Pm.Zs[(l + 1) % 2][j, q].conjugate()
                for k in range(6) for q in range(6)) - An6[l, i, j])
        for l in range(2) for i in range(6) for j in range(6))
print(f"pschur_mp (dps=40): residual {mp.nstr(worst, 3)}")
