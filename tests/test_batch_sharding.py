"""Batched + mesh-sharded model selection on an 8-device virtual CPU
mesh: sharded results must equal unsharded results."""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh

from gpy_dla_detection_tpu.data.samples import (
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu.parallel.batch import make_spectra_mesh, process_batch
from gpy_dla_detection_tpu.params import Parameters

# enough samples that the QMC z-grid resolves an injected absorber's
# damping trough (64 would under-sample the ~0.01-wide feature)
NUM_SAMPLES = 400
MAX_DLAS = 2


@pytest.fixture(scope="module")
def setup():
    params = Parameters(num_dla_samples=NUM_SAMPLES)
    learned = synthetic_learned_model(params)
    prior = synthetic_prior_catalog(params)
    dla_s = generate_dla_samples(params)
    sub_s = generate_subdla_samples(params)
    spectra = [
        synthetic_spectrum(
            params, learned, z, seed=i, dlas=[(z - 0.3, 21.3)] if i % 2 else None
        )
        for i, z in enumerate([2.9, 3.1, 3.3, 3.5, 2.8])
    ]
    return params, learned, prior, dla_s, sub_s, spectra


def test_cpu_has_8_devices():
    assert len(jax.devices("cpu")) == 8


def test_batch_matches_unsharded(setup):
    params, learned, prior, dla_s, sub_s, spectra = setup
    key = jax.random.PRNGKey(42)

    plain = process_batch(
        learned, spectra, dla_s, sub_s, prior, params, key, MAX_DLAS, mesh=None
    )

    mesh = make_spectra_mesh(jax.devices("cpu"))
    assert mesh.devices.size == 8
    sharded = process_batch(
        learned, spectra, dla_s, sub_s, prior, params, key, MAX_DLAS, mesh=mesh
    )

    assert len(plain) == len(sharded) == len(spectra)
    for a, b in zip(plain, sharded):
        np.testing.assert_allclose(a.log_evidence_null, b.log_evidence_null, rtol=1e-10)
        np.testing.assert_allclose(
            a.log_evidences_dla, b.log_evidences_dla, rtol=1e-8
        )
        np.testing.assert_allclose(a.p_dla, b.p_dla, rtol=1e-6)


@pytest.mark.parametrize(
    "variant",
    [
        dict(voigt_impl="windowed"),
        dict(voigt_impl="windowed", abs_dtype="i16p"),
        dict(abs_dtype="i16"),
    ],
    ids=["windowed", "windowed-i16p", "i16"],
)
def test_batch_variants_on_mesh_match_unsharded(setup, variant):
    """The selectable f32 variants (windowed Voigt, fixed-point profile
    storage) under shard_map over the 8-device mesh match the unsharded
    f64 reference.

    Tolerances: the null evidence is one f32 Woodbury solve (rtol 2e-5);
    the DLA evidences carry the variants' own approximations (windowed
    far field ~1e-4 relative per sample, 1.5e-5 absolute storage grid)
    summed over ~1,000 pixels, an absolute error of O(0.1) whatever the
    evidence's size (atol 0.2); p_dla atol 2e-3.

    XLA:CPU miscompiles the f32 exact-Voigt program with f32 or packed
    i16p storage once the null, subDLA and DLA evidences are fused into
    one batch program (NaN, or O(100) errors; --xla_disable_hlo_passes=
    fusion restores the right values), so those two combinations are
    checked on the GPU by chip_smoke.py and not here."""
    params, learned, prior, dla_s, sub_s, spectra = setup
    key = jax.random.PRNGKey(42)

    ref = process_batch(
        learned, spectra, dla_s, sub_s, prior, params, key, MAX_DLAS,
        mesh=None,
    )
    mesh = make_spectra_mesh(jax.devices("cpu"))
    sharded = process_batch(
        learned, spectra, dla_s, sub_s, prior, params, key, MAX_DLAS,
        mesh=mesh, dtype=np.float32, **variant,
    )
    for a, b in zip(ref, sharded):
        np.testing.assert_allclose(
            b.log_evidence_null, a.log_evidence_null, rtol=2e-5
        )
        np.testing.assert_allclose(
            b.log_evidences_dla, a.log_evidences_dla, rtol=0, atol=0.2
        )
        np.testing.assert_allclose(b.p_dla, a.p_dla, atol=2e-3)


def test_sharded_samples_axis_matches_unsharded(setup):
    """(spectra x samples) 2-D sharding: the categorical resampling and
    parameter gathers over a *sharded sample axis* (the risky
    collectives) must reproduce the unsharded result exactly — the
    resampling indices are PRNG-determined, so the chained levels match
    bit-for-bit up to reduction order (VERDICT r1 item 6)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gpy_dla_detection_tpu.data.spectrum import stack
    from gpy_dla_detection_tpu.models.evidence import (
        null_log_evidence,
        qmc_log_evidences,
    )
    from gpy_dla_detection_tpu.models.learned import build_spectrum_model

    params, learned, prior, dla_s, sub_s, spectra = setup
    B = 2
    specs = stack(spectra[:B])
    keys = jax.random.split(jax.random.PRNGKey(7), B)

    def run(specs, keys, d_off, d_lognhi, d_nhi, learned_dev):
        @jax.jit
        def step(learned, specs, d_off, d_lognhi, d_nhi, keys):
            def one(spec, key):
                model = build_spectrum_model(learned, spec, params)
                dla = qmc_log_evidences(
                    model, d_off, d_lognhi, d_nhi, key, MAX_DLAS, params
                )
                return null_log_evidence(model), dla.log_evidences, dla.base_sample_inds

            return jax.vmap(one)(specs, keys)

        return step(learned_dev, specs, d_off, d_lognhi, d_nhi, keys)

    # unsharded
    plain = run(
        specs,
        keys,
        jnp.asarray(dla_s.offset_samples),
        jnp.asarray(dla_s.log_nhi_samples),
        jnp.asarray(dla_s.nhi_samples),
        learned,
    )

    # 2x4 (spectra, samples) mesh
    devices = np.asarray(jax.devices("cpu")).reshape(2, 4)
    mesh = Mesh(devices, ("spectra", "samples"))
    spec_sh = NamedSharding(mesh, P("spectra"))
    samp_sh = NamedSharding(mesh, P("samples"))
    repl = NamedSharding(mesh, P())
    specs_d = jax.tree.map(lambda x: jax.device_put(x, spec_sh), specs)
    keys_d = jax.device_put(keys, spec_sh)
    learned_d = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(np.asarray(x)), repl), learned
    )
    sharded = run(
        specs_d,
        keys_d,
        jax.device_put(jnp.asarray(dla_s.offset_samples), samp_sh),
        jax.device_put(jnp.asarray(dla_s.log_nhi_samples), samp_sh),
        jax.device_put(jnp.asarray(dla_s.nhi_samples), samp_sh),
        learned_d,
    )

    np.testing.assert_allclose(
        np.asarray(plain[0]), np.asarray(sharded[0]), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(plain[1]), np.asarray(sharded[1]), rtol=1e-8
    )
    # identical PRNG keys -> identical resampled index chains
    np.testing.assert_array_equal(np.asarray(plain[2]), np.asarray(sharded[2]))


def test_shared_unit_tau_matches_per_model_voigt(setup):
    """The DLA and subDLA QMC sets share their redshift offsets
    (reference: multi_dlas/set_lls_parameters.m:22,59), so the batch
    layer computes the per-unit-nhi optical depth once and feeds both
    marginalizations.  That shared path must reproduce the per-model
    Voigt evaluation exactly."""
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.data.spectrum import stack
    from gpy_dla_detection_tpu.models.evidence import qmc_log_evidences
    from gpy_dla_detection_tpu.models.learned import build_spectrum_model
    from gpy_dla_detection_tpu.ops.voigt import unit_lyman_optical_depth

    params, learned, prior, dla_s, sub_s, spectra = setup
    assert np.array_equal(dla_s.offset_samples, sub_s.offset_samples)

    spec = jax.tree.map(lambda x: x[1], stack(spectra[:2]))
    model = build_spectrum_model(learned, spec, params)
    key = jax.random.PRNGKey(3)

    z_samples = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * jnp.asarray(
        dla_s.offset_samples
    )
    unit_tau = unit_lyman_optical_depth(
        model.padded_wavelengths, z_samples, params.num_lines
    )

    for s in (dla_s, sub_s):
        args = (
            model,
            jnp.asarray(s.offset_samples),
            jnp.asarray(s.log_nhi_samples),
            jnp.asarray(s.nhi_samples),
            key,
            MAX_DLAS,
            params,
        )
        plain = qmc_log_evidences(*args)
        shared = qmc_log_evidences(*args, unit_tau=unit_tau)
        np.testing.assert_allclose(
            np.asarray(plain.log_evidences),
            np.asarray(shared.log_evidences),
            rtol=1e-12,
        )
        np.testing.assert_array_equal(
            np.asarray(plain.base_sample_inds), np.asarray(shared.base_sample_inds)
        )
        np.testing.assert_allclose(
            np.asarray(plain.map_z_dlas),
            np.asarray(shared.map_z_dlas),
            rtol=1e-12,
        )


def test_injected_dla_detected(setup):
    params, learned, prior, dla_s, sub_s, spectra = setup
    results = process_batch(
        learned,
        spectra,
        dla_s,
        sub_s,
        prior,
        params,
        jax.random.PRNGKey(0),
        MAX_DLAS,
    )
    # spectra with injected strong DLAs should have high p_dla, clean
    # ones low
    for i, r in enumerate(results):
        if i % 2:  # injected
            assert r.p_dla > 0.9, (i, r.p_dla)
        else:
            assert r.p_dla < 0.5, (i, r.p_dla)
        # MAP of the injected ones should land near the truth
        if i % 2:
            z_true = [2.9, 3.1, 3.3, 3.5, 2.8][i] - 0.3
            assert abs(r.map_z_dlas[0, 0] - z_true) < 0.02, r.map_z_dlas[0]


def test_device_put_inputs_mesh_matches_host_inputs(setup):
    """device_put_inputs (the drivers' device-committed configuration)
    must be transparent: committed inputs through the sharded path give
    the same results as host numpy inputs, and the shared-offsets
    buffer is detected by identity."""
    from gpy_dla_detection_tpu.parallel.batch import device_put_inputs

    params, learned, prior, dla_s, sub_s, spectra = setup
    key = jax.random.PRNGKey(5)

    plain = process_batch(
        learned, spectra, dla_s, sub_s, prior, params, key, MAX_DLAS,
        mesh=None, dtype=np.float32,
    )

    mesh = make_spectra_mesh(jax.devices("cpu"))
    learned_d, dla_d, sub_d = device_put_inputs(
        learned, dla_s, sub_s, mesh=mesh
    )
    assert dla_d.offset_samples is sub_d.offset_samples  # one buffer
    # mixing committed-f32 inputs with f64 spectra must be rejected
    import pytest as _pytest

    with _pytest.raises(TypeError, match="learned model"):
        process_batch(
            learned_d, spectra, dla_d, sub_d, prior, params, key,
            MAX_DLAS, mesh=mesh, dtype=None,
        )
    committed = process_batch(
        learned_d, spectra, dla_d, sub_d, prior, params, key, MAX_DLAS,
        mesh=mesh, dtype=np.float32,
    )
    for a, b in zip(plain, committed):
        np.testing.assert_allclose(
            a.log_evidences_dla, b.log_evidences_dla, rtol=1e-6
        )
        np.testing.assert_allclose(a.p_dla, b.p_dla, atol=1e-6)
