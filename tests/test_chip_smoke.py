"""The GPU smoke script's phases at tiny size on the CPU, and its refusal to
run without a GPU (it must print no result line there)."""
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ok(rec):
    assert rec["ok"], rec
    for key in ("run_s", "phase"):
        assert key in rec
    return rec


def test_phase_real_small():
    rec, P, A = cs.phase_real(p=3, n=10, seed=0)
    _ok(rec)
    assert rec["iterations"] > 0
    assert rec["backerr"] < rec["backerr_bound"]
    assert rec["orth"] < rec["orth_bound"]
    assert P.Ts.shape == A.shape


@pytest.mark.parametrize("phase", [cs.phase_complex_gpsd, cs.phase_real_gpsd])
def test_phase_gpsd_small(phase):
    rec = _ok(phase(p=6, n=8))
    assert "S=TFTFTF" in rec["phase"]
    assert rec["agree_cpu"] <= cs.AGREE_TOL


def test_phase_gpsd_with_a_background_reference():
    """The script's arrangement: the CPU reference runs in another thread
    while the phase before works; the iteration count is still this
    phase's own."""
    size = dict(cs.REAL_GPSD, n=8)
    with ThreadPoolExecutor(max_workers=1) as pool:
        ref = pool.submit(cs.gpsd_reference, cplx=False, **size)
        rec = _ok(cs.phase_real_gpsd(ref=ref.result, n=8))
    assert rec["iterations"] > 0
    assert rec["agree_cpu"] <= cs.AGREE_TOL


def test_phase_ordschur_eigvecs_small():
    _, P, A = cs.phase_real(p=3, n=10, seed=4)
    rec = _ok(cs.phase_ordschur_eigvecs(P, A, k=3))
    assert rec["ev_residual"] < cs.EV_TOL
    assert rec["moved_err"] <= cs.AGREE_TOL


def test_phase_krylov_small():
    rec = _ok(cs.phase_krylov(p=2, n=64, nev=4))
    assert rec["planted_err"] <= cs.KRYLOV_TOL


def test_phase_split_small():
    rec = _ok(cs.phase_split(p=2, n=8))
    assert rec["agree_complex128"] <= cs.AGREE_TOL


def test_phase_small_eigvals():
    rec = _ok(cs.phase_small_eigvals(p=3, n=8))
    assert rec["eig_err"] <= rec["eig_bound"]


def test_phase_four_devices_on_virtual_cpus():
    rec = _ok(cs.phase_four_devices(4, batch=(3, 6), cx_batch=(2, 6),
                                    ring_n=16, krylov=(2, 64)))
    assert rec["batched_real_err"] <= cs.AGREE_TOL
    assert rec["ring_cycle_err"] <= 1e-12


def test_match_error_pairs_nearest():
    assert cs.match_error([1, 2j, 3], [3, 1, 2j]) == 0.0
    assert cs.match_error([1, 2], [1]) == float("inf")
    assert abs(cs.match_error([1.0, 2.0], [2.1, 0.95]) - 0.1) < 1e-12


def test_failed_check_marks_the_phase():
    rec = {"ok": True}
    cs._check(rec, True, "fine")
    assert rec["ok"] and "failed" not in rec
    cs._check(rec, False, "broken")
    assert not rec["ok"] and rec["failed"] == ["broken"]


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [(), ("--four-gpus",)])
def test_script_refuses_without_a_gpu(args):
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO, *args)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
