"""Device routing, backend validation, residency, meshes and the compile
cache: the parts of the library that decide where work runs."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import periodicschurdecompositions_jax as psd
from periodicschurdecompositions_jax.models import drivers
from periodicschurdecompositions_jax.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cx(rng, p=2, n=6):
    return rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))


def test_cpu_computes_complex128_natively():
    assert drivers.native_complex128(jax.devices("cpu")[0])


def test_probe_refusal_means_not_native(monkeypatch):
    def refuse(*args, **kwargs):
        raise TypeError("complex128 is not supported")
    monkeypatch.setattr(jax, "device_put", refuse)
    assert not drivers.native_complex128.__wrapped__(jax.devices("cpu")[0])


def test_probe_lost_range_means_not_native(monkeypatch):
    # a device that emulates float64 with a narrower exponent range would
    # return the doubled value out of range
    monkeypatch.setattr(jax, "jit", lambda f: (lambda v: v * np.inf))
    assert not drivers.native_complex128.__wrapped__(jax.devices("cpu")[0])


@pytest.mark.parametrize("native,core", [(True, "complex"), (False, "split")])
def test_auto_follows_capability(rng, monkeypatch, native, core):
    """backend="auto" picks the complex128 core wherever the input's device
    computes complex128 natively, else the split (re, im) core."""
    calls = []
    real_split = drivers._pschur_complex_split

    def spy_split(*args):
        calls.append("split")
        return real_split(*args)

    monkeypatch.setattr(drivers, "native_complex128", lambda dev: native)
    monkeypatch.setattr(drivers, "_pschur_complex_split", spy_split)
    A = _cx(rng)
    P = psd.pschur(jnp.asarray(A))
    assert calls == ([] if core == "complex" else ["split"])
    ok, rep = psd.check_psd(P, A)
    assert ok, rep


@pytest.mark.parametrize("backend", ["complex", "split"])
def test_explicit_backend_matches_auto(rng, backend):
    A = _cx(rng)
    v0 = np.sort_complex(np.asarray(psd.pschur(jnp.asarray(A)).values))
    v1 = np.sort_complex(np.asarray(
        psd.pschur(jnp.asarray(A), backend=backend).values))
    assert np.abs(v1 - v0).max() < 1e-10 * np.abs(v0).max()


@pytest.mark.parametrize("backend", ["ff", "f64", "Complex", ""])
def test_unknown_backend_rejected(rng, backend):
    with pytest.raises(ValueError, match="valid backends: auto, complex, "
                                         "split"):
        psd.pschur(jnp.asarray(rng.standard_normal((2, 4, 4))),
                   backend=backend)


@pytest.mark.parametrize("backend", ["auto", "complex", "split"])
def test_real_input_ignores_complex_routing(rng, backend):
    A = rng.standard_normal((2, 5, 5))
    P = psd.pschur(jnp.asarray(A), backend=backend)
    ok, rep = psd.check_psd(P, A)
    assert ok, rep


@pytest.mark.parametrize("kind", ["real", "complex", "real-gen",
                                  "complex-gen", "split"])
def test_results_stay_on_the_input_device(rng, kind):
    """Inputs committed to a non-default device keep cores and results
    there: no result is pinned to the first CPU device."""
    dev = jax.devices("cpu")[3]
    cplx = kind in ("complex", "complex-gen", "split")
    A = _cx(rng, 2, 5) if cplx else rng.standard_normal((2, 5, 5))
    S = (True, False) if kind.endswith("gen") else None
    backend = "split" if kind == "split" else "auto"
    P = psd.pschur(jax.device_put(A, dev), S=S, backend=backend)
    leaves = [x for x in jax.tree_util.tree_leaves(P) if hasattr(x, "devices")]
    assert leaves
    for x in leaves:
        assert x.devices() == {dev}, (kind, x.devices())
    ok, rep = psd.check_psd(P, A)
    assert ok, rep


def test_ordschur_returns_to_the_input_device(rng):
    dev = jax.devices("cpu")[2]
    A = rng.standard_normal((2, 6, 6))
    P = psd.pschur(jax.device_put(A, dev))
    P2 = psd.ordschur(P, [j >= 4 for j in range(6)])
    assert P2.Ts.devices() == {dev} and P2.Zs.devices() == {dev}


def test_make_mesh_raises_without_enough_devices():
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh(9)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        make_mesh(3, devices=jax.devices()[:2])


def test_make_mesh_takes_the_first_devices():
    mesh = make_mesh(4, names=("rows",))
    assert mesh.shape == {"rows": 4}
    assert list(mesh.devices.ravel()) == jax.devices()[:4]


def _cache_dir(env):
    code = ("import jax, periodicschurdecompositions_jax; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(jax.config.jax_persistent_cache_min_compile_time_secs)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_defaults_into_the_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    cache, _ = _cache_dir(env)
    assert cache == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_honours_the_environment(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    cache, min_secs = _cache_dir(env)
    assert cache == str(tmp_path)
    # nothing else is set in code: JAX's own default (1 s) stays
    assert float(min_secs) == 1.0
