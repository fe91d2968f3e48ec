"""chip_smoke.py's phase functions at tiny sizes on the CPU, and its refusal
to run without a GPU.

On the card the script runs the same functions at full width
(``python chip_smoke.py``); here they run on the host so that a broken
phase shows before a chip call.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def flagship():
    rec, solver = cs.phase_flagship(space_n=16, time_levels=3, tol=1e-8,
                                    expect_l2=None)
    return rec, solver


def test_phase_parity_tiny():
    out = cs.phase_parity(space_n=8, time_levels=3, expect_iters=None)
    assert out["iterations"] == out["oracle_iterations"]
    assert out["max_history_diff"] <= 1e-10
    assert out["l2_error"] == pytest.approx(out["oracle_l2_error"], rel=1e-9)


def test_phase_flagship_tiny(flagship):
    rec, solver = flagship
    assert rec["final_rel_residual"] <= 1e-8
    assert rec["dof"] == (solver.N + 1) * solver.m
    assert rec["inner_memory"]["temp_size_in_bytes"] is not None
    assert np.isfinite(rec["l2_error"]) and rec["l2_error"] > 0


def test_phase_flagship_checks_l2():
    with pytest.raises(AssertionError, match="L2 error"):
        cs.phase_flagship(space_n=8, time_levels=2, tol=1e-8,
                          expect_l2=1.0)


def test_phase_operators_tiny(flagship):
    _, solver = flagship
    out = cs.phase_operators(solver)
    assert set(out["max_rel_err"]) == {"apply_B", "apply_BT", "apply_KY",
                                       "wavelet_gemm"}
    assert max(out["max_rel_err"].values()) <= 1e-5
    assert out["unpinned_f32_dots"] == 0


def test_phase_xla_timings_tiny(flagship):
    _, solver = flagship
    bw = cs.copy_bandwidth(nbytes=1 << 20, reps=2)
    assert bw > 0
    out = cs.phase_xla_timings([("tiny", solver)], bw, reps=2)
    assert [r["op"].split(" (")[0] for r in out] == [
        "B/BT pair", "smoother sweep", "V-cycle"]
    assert all(r["ms"] > 0 and r["share_of_copy"] > 0 for r in out)


TINY_PATHS = (
    ("3-D multigrid", "smooth3d", 8, 0, 3, 0, "mg"),
    ("weighted multigrid", "varcoef2d", 16, 0, 3, 0, "mg"),
    ("graded time grid", "singular2d", 16, 0, 3, 2, "mg"),
    ("nested unstructured mg", "lshape2d", 4, 2, 3, 0, "mg"),
    ("smoothed-aggregation AMG", "lshape2d", 16, 0, 3, 0, "amg"),
)


@pytest.mark.parametrize("case", TINY_PATHS, ids=[c[0] for c in TINY_PATHS])
def test_phase_removed_paths_tiny(case):
    (rec,) = cs.phase_removed_paths(cases=(case,), band=(1, 40))
    assert rec["converged"]
    assert rec["inner"] != "dense"


def test_phase_removed_paths_band_enforced():
    with pytest.raises(AssertionError, match="outside"):
        cs.phase_removed_paths(cases=(TINY_PATHS[1],), band=(1, 2))


def test_phase_four_tiny():
    assert len(jax.devices()) >= 4
    out = cs.phase_four(space_n=16, time_levels=3, tol=1e-6, parity_n=8,
                        parity_levels=3)
    for name in ("sharded", "explicit", "explicit2d"):
        assert out[name]["iterations"] == out["one_device_iterations"]
        assert out[name]["history_diff_vs_r0"] <= 1e-4
    assert out["cfg1_f64_sharded"]["max_rel_history"] <= 1e-12


def _run_script(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _prints_ok(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return False
    try:
        return bool(json.loads(lines[-1]).get("ok"))
    except ValueError:
        return False


def test_main_refuses_without_gpu():
    r = _run_script(REPO)
    assert r.returncode != 0
    assert not _prints_ok(r.stdout)
    assert "no GPU device found" in r.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert not _prints_ok(r.stdout)
