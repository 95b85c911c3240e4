"""End-to-end CLI smoke test: synthetic FITS files through the batch
driver to a processed HDF5 catalog."""

import numpy as np

from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu.params import Parameters

from gpy_dla_detection_tpu.data.fits import write_speclite as _write_speclite


def test_run_bayes_select_cli(tmp_path, monkeypatch):
    import h5py

    from gpy_dla_detection_tpu import run_bayes_select

    params = Parameters(num_dla_samples=60)
    learned = synthetic_learned_model(params)

    files, zs = [], [2.9, 3.15]
    for i, z in enumerate(zs):
        wl, fx, nv, pm = synthetic_observation(
            params, learned, z, seed=i, dlas=[(z - 0.3, 21.2)] if i else None
        )
        path = str(tmp_path / f"spec-0001-55555-{i:04d}.fits")
        _write_speclite(
            path,
            fx.astype(np.float32),
            np.log10(wl).astype(np.float32),
            (1.0 / nv).astype(np.float32),
            np.where(pm, 1 << 24, 0).astype(np.int32),
        )
        files.append(path)

    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "processed.h5")
    run_bayes_select.main(
        [
            "--qso_list",
            *files,
            "--z_qso_list",
            *[str(z) for z in zs],
            "--max_dlas",
            "2",
            "--num-samples",
            "60",
            "--dtype",
            "float64",
            "--output",
            out,
            "--plot-figures",
        ]
    )

    # per-spectrum figures (reference: run_bayes_select.py:238-244)
    import os

    figures = os.listdir(out + "_figures")
    assert len(figures) == 2 and all(f.endswith(".png") for f in figures)

    with h5py.File(out, "r") as f:
        p_dlas = f["p_dlas"][()]
        assert p_dlas.shape == (2,)
        assert np.all((p_dlas >= 0) & (p_dlas <= 1))
        assert f["model_posteriors"].shape == (2, 4)
        assert f["MAP_z_dlas"].shape == (2, 2, 2)
        # the injected strong DLA should be detected
        assert p_dlas[1] > 0.5, p_dlas


def test_run_find_lls_cli(tmp_path, monkeypatch):
    import h5py

    from gpy_dla_detection_tpu import run_find_lls

    params = Parameters(num_dla_samples=50)
    learned = synthetic_learned_model(params)
    wl, fx, nv, pm = synthetic_observation(params, learned, 3.0, seed=3)
    path = str(tmp_path / "spec-0002-55555-0001.fits")
    _write_speclite(
        path,
        fx.astype(np.float32),
        np.log10(wl).astype(np.float32),
        (1.0 / nv).astype(np.float32),
        np.zeros(len(wl), np.int32),
    )
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "lls.h5")
    run_find_lls.main(
        [
            "--qso_list", path,
            "--z_qso_list", "3.0",
            "--max-lya", "2",
            "--num-samples", "50",
            "--min-lambda", "911.75",
            "--output", out,
        ]
    )
    with h5py.File(out, "r") as f:
        assert f["model_posteriors"].shape == (1, 3)
        assert np.isfinite(f["log_likelihoods_no_lya"][()]).all()


def test_run_metrics_jsonl(tmp_path, monkeypatch):
    """The driver emits a machine-readable metrics sidecar
    (utils/metrics.py RunLogger)."""
    from gpy_dla_detection_tpu import run_bayes_select
    from gpy_dla_detection_tpu.utils.metrics import read_metrics

    params = Parameters(num_dla_samples=50)
    learned = synthetic_learned_model(params)
    wl, fx, nv, pm = synthetic_observation(params, learned, 3.0, seed=9)
    path = str(tmp_path / "spec-0003-55555-0001.fits")
    _write_speclite(
        path,
        fx.astype(np.float32),
        np.log10(wl).astype(np.float32),
        (1.0 / nv).astype(np.float32),
        np.where(pm, 1 << 24, 0).astype(np.int32),
    )
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "m.h5")
    run_bayes_select.main(
        ["--qso_list", path, "missing-file.fits",
         "--z_qso_list", "3.0", "3.1",
         "--max_dlas", "1", "--num-samples", "50",
         "--dtype", "float64", "--output", out]
    )
    events = read_metrics(out + ".metrics.jsonl")
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert "spectrum_failed" in kinds and "batch_done" in kinds
    end = events[-1]
    assert end["spectra_processed"] == 1 and end["spectra_failed"] == 1
    batch = next(e for e in events if e["event"] == "batch_done")
    assert batch["spectra_per_sec"] > 0


def test_run_civ_cli(tmp_path, monkeypatch):
    """CIV CLI end to end with an injected doublet (regression: the
    search range previously used the lya wavelength and missed it)."""
    import h5py
    from scipy.special import wofz

    from gpy_dla_detection_tpu import constants as C
    from gpy_dla_detection_tpu import run_civ
    from gpy_dla_detection_tpu.params import CIVParameters

    params = CIVParameters(num_civ_samples=200)
    learned = synthetic_learned_model(params)
    z_qso, z_civ, log_n, sig = 2.2, 2.05, 14.4, 2.5e6
    wl, fx, nv, pm = synthetic_observation(params, learned, z_qso, seed=5)
    tau = np.zeros(wl.size)
    for l in range(2):
        lam_c = C.CIV_WAVELENGTHS_CM[l] * 1e8 * (1 + z_civ)
        vel = (wl - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
        zz = (vel + 1j * C.CIV_LORENTZIAN_WIDTHS[l]) / (np.sqrt(2) * sig)
        tau += (10.0**log_n * C.CIV_LEADING_CONSTANTS[l]
                * np.real(wofz(zz)) / (np.sqrt(2 * np.pi) * sig))
    path = str(tmp_path / "spec-0004-55555-0001.fits")
    _write_speclite(
        path,
        (fx * np.exp(-tau)).astype(np.float32),
        np.log10(wl).astype(np.float32),
        (1.0 / nv).astype(np.float32),
        np.where(pm, 1 << 24, 0).astype(np.int32),
    )
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "civ.h5")
    run_civ.main(
        ["--qso_list", path, "--z_qso_list", str(z_qso),
         "--num-samples", "200", "--output", out]
    )
    with h5py.File(out, "r") as f:
        assert f["p_civs"][0] > 0.99, f["p_civs"][()]


def test_run_bayes_select_checkpoint_resume(tmp_path, monkeypatch):
    """--checkpoint writes per-batch part files; a rerun resumes from
    them without touching the spectra (here they are DELETED between
    runs) and reproduces the catalog exactly."""
    import os

    import h5py

    from gpy_dla_detection_tpu import run_bayes_select

    params = Parameters(num_dla_samples=50)
    learned = synthetic_learned_model(params)
    files, zs = [], [2.9, 3.15, 3.3]
    for i, z in enumerate(zs):
        wl, fx, nv, pm = synthetic_observation(
            params, learned, z, seed=i, dlas=[(z - 0.3, 21.2)] if i else None
        )
        path = str(tmp_path / f"spec-0005-55555-{i:04d}.fits")
        _write_speclite(
            path,
            fx.astype(np.float32),
            np.log10(wl).astype(np.float32),
            (1.0 / nv).astype(np.float32),
            np.where(pm, 1 << 24, 0).astype(np.int32),
        )
        files.append(path)

    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "ckpt.h5")
    argv = [
        "--qso_list", *files, "gone.fits",
        "--z_qso_list", *[str(z) for z in zs], "3.4",
        "--max_dlas", "1", "--num-samples", "50", "--dtype", "float64",
        "--batch-size", "2", "--checkpoint", "--output", out,
    ]
    run_bayes_select.main(argv)
    parts = [f for f in os.listdir(tmp_path) if ".part" in f]
    assert len(parts) == 2  # two batches of size 2, 2 (one file missing)
    with h5py.File(out, "r") as f:
        first = f["p_dlas"][()]
        assert list(f["all_exceptions"][()]) == [3]

    # resume must not need the spectra at all, and must reproduce the
    # original run's failure record from the part files
    for path in files:
        os.remove(path)
    os.remove(out)
    run_bayes_select.main(argv)
    with h5py.File(out, "r") as f:
        np.testing.assert_array_equal(f["p_dlas"][()], first)
        assert list(f["all_exceptions"][()]) == [3]

    # parts are keyed by batch start only: resuming with a DIFFERENT
    # --batch-size must be refused (a silent resume would drop the
    # spectra beyond each stale part's coverage), not misread
    import pytest

    os.remove(out)
    argv_bad = list(argv)
    argv_bad[argv_bad.index("--batch-size") + 1] = "4"
    with pytest.raises(SystemExit, match="different --batch-size"):
        run_bayes_select.main(argv_bad)


def test_run_analysis_cli(tmp_path, monkeypatch):
    """End to end: processed catalog -> full figure set + LaTeX tables
    (the reference's make_plots.py __main__ flow as one command)."""
    import os

    import h5py

    from gpy_dla_detection_tpu import run_analysis, run_bayes_select
    from gpy_dla_detection_tpu.data.samples import generate_dla_samples

    params = Parameters(num_dla_samples=50)
    learned = synthetic_learned_model(params)
    files, zs = [], [2.9, 3.15, 3.3]
    for i, z in enumerate(zs):
        wl, fx, nv, pm = synthetic_observation(
            params, learned, z, seed=i, dlas=[(z - 0.3, 21.2)] if i else None
        )
        path = str(tmp_path / f"spec-0006-55555-{i:04d}.fits")
        _write_speclite(
            path, fx.astype(np.float32), np.log10(wl).astype(np.float32),
            (1.0 / nv).astype(np.float32),
            np.where(pm, 1 << 24, 0).astype(np.int32),
        )
        files.append(path)
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "proc.h5")
    run_bayes_select.main(
        ["--qso_list", *files, "--z_qso_list", *[str(z) for z in zs],
         "--max_dlas", "2", "--num-samples", "50", "--dtype", "float64",
         "--output", out]
    )
    samples = str(tmp_path / "samples.h5")
    s = generate_dla_samples(params)
    with h5py.File(samples, "w") as f:
        f.create_dataset("offset_samples", data=s.offset_samples[:, None])
        f.create_dataset("log_nhi_samples", data=s.log_nhi_samples[:, None])

    figdir = str(tmp_path / "figs")
    tex = str(tmp_path / "tables.tex")
    run_analysis.main(
        ["--processed", out, "--samples", samples, "--out", figdir,
         "--bins-per-z", "2", "--quick", "--tables", tex]
    )
    made = set(os.listdir(figdir))
    for stem in ["cddf_gp", "dndx_gp", "omega_gp"]:
        assert f"{stem}.pdf" in made, stem
    assert "dndx_all.txt" in made
    text = open(tex).read()
    assert text.count("\\begin{table*}") >= 3

    # two-catalog comparison overlays (self-compare is fine as a smoke)
    run_analysis.main(
        ["--processed", out, "--samples", samples, "--out", figdir,
         "--bins-per-z", "2", "--quick", "--compare", out,
         "--compare-label", "same"]
    )
    made = set(os.listdir(figdir))
    for stem in ["cddf_same", "dndx_same", "omega_same"]:
        assert f"{stem}.pdf" in made, stem


def test_run_zqso_cli(tmp_path, monkeypatch):
    """The zQSO driver end to end: synthetic FITS in, .h5 of MAP
    redshifts out (reference: tests/test_zestimation.py:22-77)."""
    import h5py

    from gpy_dla_detection_tpu import run_zqso_estimation
    from gpy_dla_detection_tpu.data.synthetic import synthetic_z_observation

    files, z_true = [], [2.5, 3.2]
    for i, z in enumerate(z_true):
        # seed=0, k=5 matches the CLI's synthetic-model fallback
        _, (wl, fx, nv, pm) = synthetic_z_observation(z, seed=0)
        path = str(tmp_path / f"spec-0002-55555-{i:04d}.fits")
        _write_speclite(
            path,
            fx.astype(np.float32),
            np.log10(wl).astype(np.float32),
            (1.0 / nv).astype(np.float32),
            np.where(pm, 1 << 24, 0).astype(np.int32),
        )
        files.append(path)

    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "zqso.h5")
    run_zqso_estimation.main(
        ["--qso_list", *files, "--num-samples", "400", "--output", out]
    )

    with h5py.File(out, "r") as f:
        z_map = f["z_map"][()]
        names = [n.decode() for n in f["qso_list"][()]]
    assert names == files
    assert z_map.shape == (2,)
    # grid spacing at 400 samples over [2.14, 6.16] is ~0.01
    np.testing.assert_allclose(z_map, z_true, atol=0.05)


def test_run_bayes_select_systematic_resampler(tmp_path, monkeypatch):
    """The survey CLI under the opt-in systematic resampler
    (GPY_DLA_RESAMPLER=systematic): the injected DLA is still detected
    and the recorded chained-level indices are one rotation of a
    sorted comb (the gather-locality property)."""
    import h5py

    from gpy_dla_detection_tpu import run_bayes_select
    from gpy_dla_detection_tpu.models import evidence

    monkeypatch.setattr(evidence, "_RESAMPLER", "systematic")
    params = Parameters(num_dla_samples=60)
    learned = synthetic_learned_model(params)
    wl, fx, nv, pm = synthetic_observation(
        params, learned, 3.15, seed=1, dlas=[(2.85, 21.3)]
    )
    path = str(tmp_path / "spec-0009-55555-0001.fits")
    _write_speclite(
        path,
        fx.astype(np.float32),
        np.log10(wl).astype(np.float32),
        (1.0 / nv).astype(np.float32),
        np.where(pm, 1 << 24, 0).astype(np.int32),
    )
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "sys.h5")
    run_bayes_select.main(
        [
            "--qso_list", path, "--z_qso_list", "3.15",
            "--max_dlas", "2", "--num-samples", "60",
            "--dtype", "float64", "--output", out,
        ]
    )
    with h5py.File(out, "r") as f:
        assert f["p_dlas"][0] > 0.5, f["p_dlas"][()]
        row = f["base_sample_inds"][()][0, :, 0]
        assert int(np.sum(np.diff(row.astype(np.int64)) < 0)) <= 1


def test_run_bayes_select_no_sample_lls(tmp_path, monkeypatch):
    """--no-sample-lls (catalog-lite): same evidences/posteriors as a
    faithful run, per-sample datasets absent from the catalog."""
    import h5py

    from gpy_dla_detection_tpu import run_bayes_select

    params = Parameters(num_dla_samples=60)
    learned = synthetic_learned_model(params)

    files, zs = [], [2.9, 3.15]
    for i, z in enumerate(zs):
        wl, fx, nv, pm = synthetic_observation(
            params, learned, z, seed=i, dlas=[(z - 0.3, 21.2)] if i else None
        )
        path = str(tmp_path / f"spec-0001-55555-{i:04d}.fits")
        _write_speclite(
            path,
            fx.astype(np.float32),
            np.log10(wl).astype(np.float32),
            (1.0 / nv).astype(np.float32),
            np.where(pm, 1 << 24, 0).astype(np.int32),
        )
        files.append(path)

    monkeypatch.chdir(tmp_path)
    base = [
        "--qso_list", *files,
        "--z_qso_list", *[str(z) for z in zs],
        "--max_dlas", "2",
        "--num-samples", "60",
    ]
    run_bayes_select.main(base + ["--output", str(tmp_path / "full.h5")])
    run_bayes_select.main(
        base + ["--output", str(tmp_path / "lite.h5"), "--no-sample-lls"]
    )

    with h5py.File(str(tmp_path / "full.h5")) as ff, h5py.File(
        str(tmp_path / "lite.h5")
    ) as fl:
        assert "sample_log_likelihoods_dla" in ff
        assert "sample_log_likelihoods_dla" not in fl
        assert "base_sample_inds" not in fl
        for name in (
            "p_dlas", "model_posteriors", "MAP_z_dlas", "MAP_log_nhis",
            "log_likelihoods_dla", "log_likelihoods_no_dla",
        ):
            np.testing.assert_array_equal(ff[name][()], fl[name][()])
