"""ctypes bindings for the native C++ host implementation (native/pschur_cpu.cpp).

The shared library implements the reference's scalar algorithm shape
(periodic Hessenberg reduction + Francis double-shift periodic QR, reference
/root/reference/src/PeriodicSchurDecompositions.jl:213-259,322-1096) as
sequential -O3 C++.  Two roles:

* the single-core CPU baseline that ``chip_smoke.py`` compares the device
  pipeline against (the reference publishes no numbers — BASELINE.md
  documents the methodology);
* a fast exact-float64 host backend for the small sequential window
  solves (AED, Krylov projected problems).

Built on demand from the source with g++ into ``native/build/`` (git
ignored; plain C ABI + ctypes).  The build is keyed by the source and the
host CPU, since it uses ``-march=native``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "pschur_cpu.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "native", "build")

_lib = None
_load_failed = False


def _host_key() -> str:
    """Cache key covering the source AND the host CPU (-march=native)."""
    h = hashlib.sha1()
    try:
        with open(_SRC, "rb") as f:
            h.update(f.read())
    except OSError:
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    h.update(line.encode())
                    if line.startswith("flags"):
                        break
    except OSError:
        import platform
        h.update(platform.processor().encode())
    return h.hexdigest()[:16]


def _cache_so() -> str:
    return os.path.join(_BUILD_DIR, f"libpschur_cpu-{_host_key()}.so")


def _selftest(so_path: str) -> bool:
    """Probe a fresh build in a subprocess (a bad -march=native build dies
    with SIGILL there instead of taking this process down)."""
    code = (
        "import ctypes, numpy as np\n"
        f"lib = ctypes.CDLL({so_path!r})\n"
        "assert hasattr(lib, 'pqz_complex_cpu')\n"
        "assert hasattr(lib, 'pqz_real_gen_cpu')\n"
        "dp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))\n"
        "T = np.random.default_rng(0).standard_normal((2, 4, 4))\n"
        "H = np.zeros_like(T); Q = np.zeros_like(T)\n"
        "H[:] = T\n"
        "lib.phessenberg_cpu(2, 4, dp(H), dp(Q), 1)\n"
        "Z = np.zeros_like(H); wr = np.zeros(4); wi = np.zeros(4)\n"
        "rc = lib.pschur_real_cpu(2, 4, dp(H), dp(Z), dp(wr), dp(wi), 30, 1)\n"
        "assert rc == 0\n"
        "print('NATIVE_OK')\n")
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, timeout=120)
        return r.returncode == 0 and b"NATIVE_OK" in r.stdout
    except (OSError, subprocess.SubprocessError):
        return False


def _build(out_so: str) -> bool:
    if not os.path.exists(_SRC):
        return False
    try:
        os.makedirs(os.path.dirname(out_so), exist_ok=True)
        tmp = out_so + f".tmp.{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", tmp, _SRC],
            check=True, capture_output=True)
        os.replace(tmp, out_so)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    # the build is keyed by source hash + CPU model/flags, so a binary never
    # outlives its host or its source.  Any failure -> None (callers fall
    # back to the jitted exact-f64 cores).
    so = _cache_so()
    if not os.path.exists(so):
        if not (_build(so) and _selftest(so)):
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        _load_failed = True
        return None
    if not hasattr(lib, "pqz_complex_cpu"):
        _load_failed = True
        return None
    lib.pschur_real_cpu.restype = ctypes.c_int
    lib.pschur_real_cpu.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int]
    lib.phessenberg_cpu.restype = None
    lib.phessenberg_cpu.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int]
    lib.pqz_complex_cpu.restype = ctypes.c_int
    lib.pqz_complex_cpu.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int]
    if hasattr(lib, "pqz_real_gen_cpu"):
        lib.pqz_real_gen_cpu.restype = ctypes.c_int
        lib.pqz_real_gen_cpu.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int]
    if hasattr(lib, "pqz_real_gen_niter_cpu"):
        lib.pqz_real_gen_niter_cpu.restype = ctypes.c_int
        lib.pqz_real_gen_niter_cpu.argtypes = (
            lib.pqz_real_gen_cpu.argtypes + [ctypes.POINTER(ctypes.c_int)])
    _lib = lib
    return lib


def available() -> bool:
    """True if the native host library is loadable (builds it if needed)."""
    return _load() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def pschur_real_cpu(A, maxitfac: int = 30, want_z: bool = True
                    ) -> Tuple[np.ndarray, Optional[np.ndarray],
                               np.ndarray, np.ndarray]:
    """Real periodic Schur decomposition on the host (native C++).

    Args:
      A: (p, n, n) real cycle (right orientation: product A[0]...A[p-1]).

    Returns:
      (T, Z, wr, wi): quasi-triangular stack, orthogonal factors with
      ``Z[l].T @ A[l] @ Z[(l+1)%p] = T[l]``, eigenvalue parts.

    Raises:
      RuntimeError: if the library is unavailable or the iteration fails.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable (g++ missing?)")
    T = np.array(A, np.float64, order="C", copy=True)
    if T.ndim != 3 or T.shape[1] != T.shape[2]:
        raise ValueError(f"expected (p, n, n), got {T.shape}")
    p, n, _ = T.shape
    Z = np.zeros_like(T)
    wr = np.zeros(n)
    wi = np.zeros(n)
    rc = lib.pschur_real_cpu(p, n, _dp(T), _dp(Z), _dp(wr), _dp(wi),
                             int(maxitfac), int(bool(want_z)))
    if rc != 0:
        raise RuntimeError(f"native pschur_real_cpu failed to converge (rc={rc})")
    return T, (Z if want_z else None), wr, wi


def phessenberg_cpu(A, want_q: bool = True
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Periodic Hessenberg reduction on the host (native C++)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable (g++ missing?)")
    H = np.array(A, np.float64, order="C", copy=True)
    p, n, _ = H.shape
    Q = np.zeros_like(H)
    lib.phessenberg_cpu(p, n, _dp(H), _dp(Q), int(bool(want_q)))
    return H, (Q if want_q else None)


def pqz_complex_cpu(H, S, maxitfac: int = 30, want_z: bool = True):
    """Complex periodic QZ of a Hessenberg+triangular cycle (native C++).

    The common NONSINGULAR fast path for the AED window analyses
    (ops/aed.py): input ``H`` (p, n, n) complex128 with H[0] upper
    Hessenberg and H[1:] upper triangular, ``S`` the signature.

    Returns (T, Z, alpha, beta, scal) or None when the native core
    declined (rc=2: a negligible triangular diagonal needs the full
    singular-factor machinery; rc=1: budget exhausted) — the caller
    falls back to the jitted exact core.

    Raises RuntimeError when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable (g++ missing?)")
    T = np.array(H, np.complex128, order="C", copy=True)
    p, n, _ = T.shape
    Sa = np.ascontiguousarray(
        [1 if bool(s) else -1 for s in S], dtype=np.int32)
    Z = np.zeros_like(T)
    alpha = np.zeros(n, np.complex128)
    beta = np.zeros(n, np.float64)
    scal = np.zeros(n, np.int32)
    dpz = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa
    ipz = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))  # noqa
    rc = lib.pqz_complex_cpu(p, n, dpz(T), ipz(Sa), dpz(Z), dpz(alpha),
                             dpz(beta), ipz(scal), int(maxitfac),
                             int(bool(want_z)))
    if rc != 0:
        return None
    return T, (Z if want_z else None), alpha, beta, scal


def pqz_real_gen_cpu(H, S, maxitfac: int = 120, want_z: bool = True):
    """Real generalized periodic QZ of a Hessenberg+triangular signed cycle
    (native C++).

    The common NONSINGULAR fast path for the real-generalized AED window
    analyses (ops/aed.py): input ``H`` (p, n, n) float64 with H[0] upper
    Hessenberg and H[1:] upper triangular, ``S`` the signature (S[0] True).
    Mirrors the re-designed shift scheme of ops/pqz_real.pqz_real_gen_core
    (exact window-product shifts, 2x2 attack, MB03BD scope — reference
    /root/reference/src/rgeneralized.jl:49-1083).

    Returns (T, Z, alpha_r, alpha_i, beta, scal) or None when the native
    core declined (rc=2: a negligible triangular diagonal needs the full
    singular-factor machinery; rc=1: budget exhausted) — the caller falls
    back to the jitted exact core.

    Raises RuntimeError when the library is unavailable or the binding is
    missing (stale cached .so).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "pqz_real_gen_cpu"):
        raise RuntimeError("native pqz_real_gen_cpu unavailable")
    T = np.array(H, np.float64, order="C", copy=True)
    p, n, _ = T.shape
    Sa = np.ascontiguousarray(
        [1 if bool(s) else -1 for s in S], dtype=np.int32)
    Z = np.zeros_like(T)
    alr = np.zeros(n)
    ali = np.zeros(n)
    beta = np.zeros(n)
    scal = np.zeros(n, np.int32)
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))  # noqa
    rc = lib.pqz_real_gen_cpu(p, n, _dp(T), ip(Sa), _dp(Z), _dp(alr),
                              _dp(ali), _dp(beta), ip(scal), int(maxitfac),
                              int(bool(want_z)))
    if rc != 0:
        return None
    return T, (Z if want_z else None), alr, ali, beta, scal


def pqz_real_gen_niter_cpu(H, S, maxitfac: int = 120, want_z: bool = True):
    """Like :func:`pqz_real_gen_cpu` but also reports the iteration count.

    Returns (rc, niter, out): rc 0 ok / 1 budget exhausted / 2 declined;
    ``out`` is the (T, Z, alr, ali, beta, scal) tuple when rc == 0 else
    None.  The harness for the adversarial shift-scheme validation
    (tests/test_rg_hostile.py): the native core runs the SAME
    re-designed shift scheme as ops/pqz_real.pqz_real_gen_core, so its
    iteration counts proxy the jitted core's at ~1000x the speed.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "pqz_real_gen_niter_cpu"):
        raise RuntimeError("native pqz_real_gen_niter_cpu unavailable")
    T = np.array(H, np.float64, order="C", copy=True)
    p, n, _ = T.shape
    Sa = np.ascontiguousarray(
        [1 if bool(s) else -1 for s in S], dtype=np.int32)
    Z = np.zeros_like(T)
    alr = np.zeros(n)
    ali = np.zeros(n)
    beta = np.zeros(n)
    scal = np.zeros(n, np.int32)
    niter = ctypes.c_int(0)
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))  # noqa
    rc = lib.pqz_real_gen_niter_cpu(
        p, n, _dp(T), ip(Sa), _dp(Z), _dp(alr), _dp(ali), _dp(beta),
        ip(scal), int(maxitfac), int(bool(want_z)), ctypes.byref(niter))
    out = (T, (Z if want_z else None), alr, ali, beta, scal) \
        if rc == 0 else None
    return rc, int(niter.value), out
