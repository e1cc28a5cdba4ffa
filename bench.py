"""Flagship benchmark: real periodic Schur decomposition, N=512, p=16, on
one GPU.

Runs ``psd.pschur`` through the public API on the GPU and the repo's native
C++ implementation of the reference's scalar algorithm (native/
pschur_cpu.cpp: MB03VD-style reduction + MB03WD-style double-shift periodic
QR, -O3, one core; methodology in BASELINE.md) on the host, on the same
draw.  Compile seconds (a first call on a triangular cycle of the same
shape) and run seconds are printed apart on stderr with the card's name and
power limit; stdout gets ONE JSON line:

  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": speedup,
   "compile_s": ..., "backward_error": ..., "card": ...}

``vs_baseline`` = cpp_seconds / gpu_seconds (> 1: the GPU run is faster).
Refuses to run (exit 2, no JSON line) without a GPU.

Usage:  python bench.py
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

P_CYCLE = 16
N = 512
MAXITFAC = 40


def _backerr(A, T, Z):
    """Largest per-factor ||A_l - Z_l T_l Z_{l+1}'||_1 / ||A_l||_1."""
    p = T.shape[0]
    return max(np.linalg.norm(Z[l] @ T[l] @ Z[(l + 1) % p].T - A[l], 1) /
               np.linalg.norm(A[l], 1) for l in range(p))


def main() -> int:
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] no GPU: JAX's default platform is {dev.platform!r}",
              file=sys.stderr)
        return 2
    import periodicschurdecompositions_jax as psd
    from chip_smoke import card_line
    from periodicschurdecompositions_jax import native

    card = card_line()
    print(f"[bench] card: {card}", file=sys.stderr)
    rng = np.random.default_rng(12345)
    A = rng.standard_normal((P_CYCLE, N, N))
    warm = np.stack([np.diag(rng.uniform(1.0, 2.0, N))
                     for _ in range(P_CYCLE)])

    t0 = time.perf_counter()
    jax.block_until_ready(psd.pschur(jax.device_put(warm),
                                     maxitfac=MAXITFAC))
    t_compile = time.perf_counter() - t0
    Ad = jax.block_until_ready(jax.device_put(A))
    t0 = time.perf_counter()
    P = jax.block_until_ready(psd.pschur(Ad, maxitfac=MAXITFAC))
    t_gpu = time.perf_counter() - t0
    err = _backerr(A, np.asarray(P.Ts), np.asarray(P.Zs))
    print(f"[bench] pschur p={P_CYCLE} n={N}: compile {t_compile:.3f} s, "
          f"run {t_gpu:.3f} s, backerr {err:.3e} ({card})", file=sys.stderr)

    vs = 0.0
    if native.available():
        t0 = time.perf_counter()
        native.pschur_real_cpu(A, maxitfac=MAXITFAC)
        t_cpp = time.perf_counter() - t0
        vs = t_cpp / t_gpu
        print(f"[bench] native C++ baseline (1 core): {t_cpp:.3f} s",
              file=sys.stderr)
    else:
        print("[bench] native baseline unavailable; vs_baseline=0",
              file=sys.stderr)
    print(json.dumps({
        "metric": (f"pschur real wall-clock p={P_CYCLE} n={N} float64 "
                   f"(one GPU, vs native C++ single-core baseline)"),
        "value": t_gpu,
        "unit": "s",
        "vs_baseline": vs,
        "compile_s": t_compile,
        "backward_error": err,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
