"""Rehearsal of chip_smoke.py's phases on the CPU at a tiny width: the
same functions, paths and control flow the card runs, with the device
check left out.  The numbers here say nothing about the card."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from gpy_dla_detection_tpu.params import Parameters

NUM_SAMPLES = 300


@pytest.fixture(scope="module")
def inputs():
    params = Parameters(num_dla_samples=NUM_SAMPLES)
    return (params,) + cs.make_model_inputs(params)


def test_chip_smoke_phases_rehearse_on_cpu(inputs, tmp_path):
    params, learned, prior, dla_s, sub_s = inputs
    report = cs.phase_compile(params, learned, dla_s, sub_s, batch_sizes=(2,))
    assert report[2]["total_bytes"] > 0 and report[2]["fits"]

    # float64: XLA:CPU miscompiles the fused f32 exact-Voigt batch program
    # (models/evidence.py notes; PERF.md), the card runs it in f32
    files, z_qsos, truth, cat = cs.phase_main_path(
        params, learned, str(tmp_path), n=4, num_samples=NUM_SAMPLES,
        batch_size=2, dtype="float64",
    )
    assert len(files) == 4 and sum(t is not None for t in truth) == 2
    assert os.path.exists(tmp_path / "cli" / "catalog.npz.part00000002.pkl")

    picks, ref = cs.phase_reference(
        params, learned, prior, dla_s, sub_s, files, z_qsos, truth, cat
    )
    assert picks == [2, 3, 0]
    cs.phase_variants(
        params, learned, prior, dla_s, sub_s, files, z_qsos, picks, ref, cat,
        variants={"windowed": {"voigt_impl": "windowed"}}, timing=False,
    )


def test_chip_smoke_four_cards_rehearse_on_cpu(inputs, tmp_path):
    """Phase 6 on four of the virtual CPU devices against one."""
    params, learned, _, _, _ = inputs
    cs.phase_four_cards(params, learned, str(tmp_path), n=8,
                        num_samples=NUM_SAMPLES, dtype="float64")
    for ndev in (4, 1):
        assert (tmp_path / "four" / f"catalog_{ndev}dev.npz").exists()


def test_chip_smoke_compare_catalogs_flags_differences():
    cat = {
        "log_likelihoods_no_dla": np.array([100.0, 200.0]),
        "log_likelihoods_lls": np.array([[90.0], [190.0]]),
        "log_likelihoods_dla": np.array([[95.0, 80.0], [180.0, 170.0]]),
        "p_dlas": np.array([0.2, 0.9]),
        "model_posteriors": np.array([[0.8, 0.0, 0.2], [0.1, 0.0, 0.9]]),
        "base_sample_inds": np.zeros((2, 4, 1), np.int32),
    }
    worst, same = cs.compare_catalogs(cat, cat)
    assert all(v == 0 for v in worst.values()) and same == 1.0
    other = dict(cat, p_dlas=cat["p_dlas"] + [0.0, 0.01])
    assert cs.compare_catalogs(other, cat)[0]["p_dla_abs"] == pytest.approx(0.01)


def test_chip_smoke_refuses_without_gpu():
    """Without a GPU the script fails at once, prints no result line and
    exits non-zero."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=repo, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    """Alone in a directory, without the package, the script fails."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import shutil

    shutil.copy(os.path.join(repo, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
