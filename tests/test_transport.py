"""Compact readback transport (parallel/batch.TransportBatch): the
f16-centered / uint16 packing must decode to the raw results — the
survey driver reads back the packed form, half the bytes of the raw
outputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpy_dla_detection_tpu.data.samples import (
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu.data.spectrum import astype
from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu.parallel.batch import dispatch_batch, finalize_batch
from gpy_dla_detection_tpu.params import Parameters


def test_compact_transport_decodes_to_raw():
    params = Parameters(num_dla_samples=300)
    learned = synthetic_learned_model(params)
    prior = synthetic_prior_catalog(params)
    dla_s = generate_dla_samples(params)
    sub_s = generate_subdla_samples(params)
    spectra = [
        astype(
            synthetic_spectrum(
                params, learned, z, seed=i, dlas=[(z - 0.3, 21.2)] if i % 2 else None
            ),
            np.float32,
        )
        for i, z in enumerate([2.9, 3.2, 3.4])
    ]
    key = jax.random.PRNGKey(5)

    raw = dispatch_batch(
        learned, spectra, dla_s, sub_s, params, key, 3,
        dtype=jnp.float32, compact=False,
    )
    packed = dispatch_batch(
        learned, spectra, dla_s, sub_s, params, key, 3,
        dtype=jnp.float32, compact=True,
    )
    r_raw = finalize_batch(raw, spectra, sub_s, prior, 3)
    r_pk = finalize_batch(packed, spectra, sub_s, prior, 3)

    assert len(r_raw) == len(r_pk) == 3
    for a, b in zip(r_raw, r_pk):
        # evidences, MAP chains, posteriors ride the transport
        # untouched: bit-identical
        assert a.log_evidence_null == b.log_evidence_null
        np.testing.assert_array_equal(a.log_evidences_dla, b.log_evidences_dla)
        np.testing.assert_array_equal(a.map_z_dlas, b.map_z_dlas)
        np.testing.assert_array_equal(a.map_log_nhis, b.map_log_nhis)
        np.testing.assert_array_equal(a.base_sample_inds, b.base_sample_inds)
        assert a.p_dla == b.p_dla
        # sample lls: f16-centered decode, NaN pattern preserved, and
        # error bounded by the f16 grid near the max (what the analysis
        # consumes through exp(ll - max))
        for x, y in (
            (a.sample_log_likelihoods_dla, b.sample_log_likelihoods_dla),
            (a.sample_log_likelihoods_subdla, b.sample_log_likelihoods_subdla),
        ):
            assert np.array_equal(np.isnan(x), np.isnan(y))
            fin = np.isfinite(x)
            if not fin.any():
                continue
            centered = x[fin] - x[fin].max()
            err = np.abs(x[fin] - y[fin])
            # 2^-11 relative on the centered magnitude, plus a tiny
            # absolute floor near zero
            assert np.all(err <= np.abs(centered) * 2**-10 + 1e-3), err.max()


def test_compact_auto_resolution():
    """auto = compact for f32, raw for f64 (the conformance dtype)."""
    from gpy_dla_detection_tpu.parallel.batch import TransportBatch

    params = Parameters(num_dla_samples=64, num_pixels_padded=256,
                        min_lambda=1140.0, max_lambda=1190.0,
                        normalization_min_lambda=1195.0,
                        normalization_max_lambda=1215.0)
    learned = synthetic_learned_model(params)
    dla_s = generate_dla_samples(params)
    sub_s = generate_subdla_samples(params)
    spec = synthetic_spectrum(params, learned, 3.0, seed=0)
    key = jax.random.PRNGKey(0)

    out32 = dispatch_batch(
        learned, [astype(spec, np.float32)], dla_s, sub_s, params, key, 2,
        dtype=jnp.float32,
    )
    assert isinstance(out32, TransportBatch)
    assert out32.base_sample_inds.dtype == jnp.uint16
    out64 = dispatch_batch(
        learned, [astype(spec, np.float64)], dla_s, sub_s, params, key, 2,
        dtype=jnp.float64,
    )
    assert not isinstance(out64, TransportBatch)


def test_catalog_lite_transport(tmp_path):
    """with_sample_lls=False: evidences/MAPs/posteriors bit-identical to
    the full transport, per-sample arrays dropped end to end (None in
    SpectrumResult, absent from the written catalog)."""
    import h5py

    from gpy_dla_detection_tpu.catalog_io import write_catalog
    from gpy_dla_detection_tpu.parallel.batch import TransportBatch

    params = Parameters(num_dla_samples=300)
    learned = synthetic_learned_model(params)
    prior = synthetic_prior_catalog(params)
    dla_s = generate_dla_samples(params)
    sub_s = generate_subdla_samples(params)
    spectra = [
        astype(
            synthetic_spectrum(
                params, learned, z, seed=i, dlas=[(z - 0.3, 21.2)] if i % 2 else None
            ),
            np.float32,
        )
        for i, z in enumerate([2.9, 3.2])
    ]
    key = jax.random.PRNGKey(5)

    full = dispatch_batch(
        learned, spectra, dla_s, sub_s, params, key, 3, dtype=jnp.float32,
    )
    lite = dispatch_batch(
        learned, spectra, dla_s, sub_s, params, key, 3, dtype=jnp.float32,
        with_sample_lls=False,
    )
    assert isinstance(lite, TransportBatch)
    assert lite.dla_sll_centered.shape[1] == 0
    # the lite payload is tiny: no (S,)-sized leaf survives
    assert all(
        np.prod(np.asarray(leaf).shape) < 100 for leaf in jax.tree.leaves(lite)
    )
    r_full = finalize_batch(full, spectra, sub_s, prior, 3)
    r_lite = finalize_batch(lite, spectra, sub_s, prior, 3)
    for a, b in zip(r_full, r_lite):
        assert a.log_evidence_null == b.log_evidence_null
        np.testing.assert_array_equal(a.log_evidences_dla, b.log_evidences_dla)
        np.testing.assert_array_equal(a.map_z_dlas, b.map_z_dlas)
        np.testing.assert_array_equal(a.map_log_nhis, b.map_log_nhis)
        assert a.p_dla == b.p_dla
        assert b.sample_log_likelihoods_dla is None
        assert b.sample_log_likelihoods_subdla is None
        assert b.base_sample_inds is None

    out = str(tmp_path / "lite.h5")
    write_catalog(out, r_lite, params, 3, [2.9, 3.2], ["a", "b"])
    with h5py.File(out) as f:
        assert "sample_log_likelihoods_dla" not in f
        assert "base_sample_inds" not in f
        assert f["p_dlas"].shape == (2,)
        np.testing.assert_allclose(
            f["p_dlas"][:], [r.p_dla for r in r_lite]
        )
