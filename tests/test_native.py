"""Native C++ kernels vs scipy and the Python/JAX implementations."""

import numpy as np
import pytest

native = pytest.importorskip("gpy_dla_detection_tpu.native")


@pytest.fixture(scope="module", autouse=True)
def _built():
    try:
        native.load()
    except Exception as e:  # no toolchain
        pytest.skip(f"native build unavailable: {e}")


def test_native_faddeeva_matches_scipy():
    from scipy.special import wofz

    x = np.concatenate([np.linspace(-10, 10, 201), np.logspace(1, 4, 101)])
    y = np.full_like(x, 4.72e-4)
    ref = wofz(x + 1j * y).real
    got = native.faddeeva_real(x, y)
    np.testing.assert_allclose(got, ref, rtol=2e-9)


def test_native_voigt_matches_reference():
    """Native Voigt profile == the in-repo f64 exact path
    (ops/voigt.voigt_absorption, impl="exact")."""
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.ops.voigt import voigt_absorption

    wl = 3600.0 * 10 ** (1e-4 * np.arange(1000))
    nhi = np.array([10**20.3, 10**21.5])
    z = np.array([2.5, 3.0])
    got = native.voigt_absorption(wl, nhi, z, num_lines=3)
    want = np.asarray(
        voigt_absorption(
            jnp.asarray(wl), jnp.asarray(nhi), jnp.asarray(z), 3, impl="exact"
        )
    )
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-6)


def test_native_preprocess_matches_python():
    from gpy_dla_detection_tpu.data.spectrum import preprocess
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
    )
    from gpy_dla_detection_tpu.params import Parameters

    params = Parameters()
    learned = synthetic_learned_model(params)
    wl, fx, nv, pm = synthetic_observation(params, learned, 3.1, seed=5)

    py = preprocess(wl, fx, nv, pm, 3.1, params)
    nat = native.preprocess_spectrum(wl, fx, nv, pm, 3.1, params)

    np.testing.assert_allclose(nat.padded_wavelengths, py.padded_wavelengths, rtol=1e-12)
    np.testing.assert_allclose(nat.flux, py.flux, rtol=1e-12)
    np.testing.assert_allclose(nat.noise_variance, py.noise_variance, rtol=1e-12)
    assert np.array_equal(nat.mask, py.mask)
    np.testing.assert_allclose(float(nat.normalization_median), float(py.normalization_median), rtol=1e-12)
    np.testing.assert_allclose(float(nat.min_z_dla), float(py.min_z_dla), rtol=1e-12)
    np.testing.assert_allclose(float(nat.max_z_dla), float(py.max_z_dla), rtol=1e-12)


def test_native_lls_matches_jax():
    """Native LLS-break absorption == ops/voigt.py f64."""
    import jax.numpy as jnp

    from gpy_dla_detection_tpu import native
    from gpy_dla_detection_tpu.ops.voigt import voigt_absorption_lls

    # grid straddling the absorbers' rest-frame Lyman limit
    # (911.76 * (1 + 2.4) ~ 3100 A observed)
    wl = 2900.0 * 10 ** (1e-4 * np.arange(400))
    nhi = np.array([10.0**19.0, 10.0**20.5])
    z = np.array([2.4, 2.55])
    got = native.voigt_absorption_lls(wl, nhi, z, num_lines=3)
    want = np.asarray(
        voigt_absorption_lls(jnp.asarray(wl), jnp.asarray(nhi), jnp.asarray(z), 3)
    )
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    # the break must actually bite below the limit for a strong absorber
    plain = native.voigt_absorption(wl, nhi, z, num_lines=3)
    assert np.any(got < plain - 1e-6)


def test_native_civ_matches_jax():
    """Native CIV doublet (free per-sample sigma) == ops/voigt.py f64."""
    import jax.numpy as jnp

    from gpy_dla_detection_tpu import native
    from gpy_dla_detection_tpu.ops.voigt import voigt_absorption_civ

    wl = 1548.0 * 3.0 * 10 ** (1e-4 * np.arange(300))
    nciv = np.array([10.0**13.5, 10.0**14.5])
    z = np.array([1.98, 2.01])
    sigma = np.array([2.0e6, 4.0e6])
    got = native.voigt_absorption_civ(wl, nciv, z, sigma)
    want = np.asarray(
        voigt_absorption_civ(
            jnp.asarray(wl), jnp.asarray(nciv), jnp.asarray(z), jnp.asarray(sigma)
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
