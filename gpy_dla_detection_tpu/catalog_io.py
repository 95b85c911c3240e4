"""Processed-catalog writer: HDF5 (or numpy ``.npz``) output with the
layout and variable names of the reference driver's catalog
(reference: run_bayes_select.py:248-295), so downstream CDDF analysis
tooling works on either pipeline's output.
"""

from __future__ import annotations

import numpy as np

from .models.pipeline import SpectrumResult
from .params import Parameters


def results_to_arrays(
    results: list[SpectrumResult], params: Parameters, max_dlas: int
):
    """Stack per-spectrum results into the catalog arrays."""
    n = len(results)
    S = params.num_dla_samples
    out = {
        "min_z_dlas": np.array([r.min_z_dla for r in results]),
        "max_z_dlas": np.array([r.max_z_dla for r in results]),
        "log_priors_no_dla": np.array([r.selection.log_priors[0] for r in results]),
        "log_priors_lls": np.array([r.selection.log_priors[1] for r in results]),
        "log_priors_dla": np.stack([r.selection.log_priors[-max_dlas:] for r in results]),
        "log_likelihoods_no_dla": np.array([r.log_evidence_null for r in results]),
        "log_likelihoods_lls": np.array([r.log_evidence_subdla for r in results]),
        "log_likelihoods_dla": np.stack([r.log_evidences_dla for r in results]),
        "log_posteriors_no_dla": np.array(
            [r.selection.log_posteriors[0] for r in results]
        ),
        "log_posteriors_lls": np.array(
            [r.selection.log_posteriors[1] for r in results]
        ),
        "log_posteriors_dla": np.stack(
            [r.selection.log_posteriors[-max_dlas:] for r in results]
        ),
        "MAP_z_dlas": np.stack([r.map_z_dlas for r in results]),
        "MAP_log_nhis": np.stack([r.map_log_nhis for r in results]),
        "model_posteriors": np.stack(
            [r.selection.model_posteriors for r in results]
        ),
        "p_dlas": np.array([r.p_dla for r in results]),
        "p_no_dlas": np.array([r.p_no_dla for r in results]),
    }
    if results[0].sample_log_likelihoods_dla is not None:
        # omitted entirely in catalog-lite runs (dispatch_batch
        # with_sample_lls=False); the reference driver always writes
        # them (reference: run_bayes_select.py:266-295)
        out["sample_log_likelihoods_dla"] = np.stack(
            [r.sample_log_likelihoods_dla for r in results]
        )
        out["sample_log_likelihoods_lls"] = np.stack(
            [r.sample_log_likelihoods_subdla for r in results]
        )
        out["base_sample_inds"] = np.stack(
            [r.base_sample_inds.T for r in results]
        ).astype(np.int32)
        assert out["sample_log_likelihoods_dla"].shape == (n, S, max_dlas)
    return out


def catalog_datasets(
    results: list[SpectrumResult],
    params: Parameters,
    max_dlas: int,
    z_qso_list,
    qso_list,
    all_exceptions=None,
) -> dict:
    """Every dataset of the processed catalog, by the reference's names
    (reference: run_bayes_select.py:248-295), as numpy values."""
    out = {
        "prior_z_qso_increase": params.prior_z_qso_increase,
        "k": params.k,
        "normalization_min_lambda": params.normalization_min_lambda,
        "normalization_max_lambda": params.normalization_max_lambda,
        "min_z_cut": params.min_z_cut,
        "max_z_cut": params.max_z_cut,
        "num_dla_samples": params.num_dla_samples,
        "num_lines": params.num_lines,
        "num_forest_lines": params.num_forest_lines,
    }
    out = {name: np.asarray(value) for name, value in out.items()}
    out.update(results_to_arrays(results, params, max_dlas))
    out["z_qsos"] = np.asarray(z_qso_list, np.float64)
    out["qso_list"] = np.asarray(qso_list, dtype=str)
    if all_exceptions:
        out["all_exceptions"] = np.asarray(all_exceptions)
    return out


def write_catalog(
    filename: str,
    results: list[SpectrumResult],
    params: Parameters,
    max_dlas: int,
    z_qso_list,
    qso_list,
    all_exceptions=None,
):
    """Write the processed catalog with the reference's dataset names.

    The container follows the suffix: ``.npz`` is written by numpy alone
    (string datasets as unicode arrays); anything else is HDF5 through
    h5py, the reference's format (strings as UTF-8).  Both hold the same
    datasets with the same values.
    """
    arrays = catalog_datasets(
        results, params, max_dlas, z_qso_list, qso_list, all_exceptions
    )
    if filename.endswith(".npz"):
        with open(filename, "wb") as f:
            np.savez(f, **arrays)
        return
    import h5py

    with h5py.File(filename, "w") as f:
        for name, arr in arrays.items():
            if arr.dtype.kind == "U":
                arr = arr.astype(h5py.string_dtype(encoding="utf-8"))
            f.create_dataset(name, data=arr)


def read_catalog(filename: str) -> dict:
    """All datasets of a catalog written by :func:`write_catalog`, as
    numpy arrays (strings as ``str``), from either container."""
    if filename.endswith(".npz"):
        with np.load(filename) as z:
            return {name: z[name] for name in z.files}
    import h5py

    out = {}
    with h5py.File(filename, "r") as f:
        for name in f:
            arr = f[name][()]
            if isinstance(arr, np.ndarray) and arr.dtype.kind in "OS":
                arr = np.asarray(
                    [x.decode() if isinstance(x, bytes) else x for x in arr],
                    dtype=str,
                )
            out[name] = np.asarray(arr)
    return out
