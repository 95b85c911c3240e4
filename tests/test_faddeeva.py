"""Validate the JAX Faddeeva function against scipy.special.wofz."""

import numpy as np
import pytest
from scipy.special import wofz as scipy_wofz

from gpy_dla_detection_tpu.ops.faddeeva import voigt_profile, wofz_parts


def _grid():
    # x: dense near the core, log-spaced into the far damping wings
    x = np.concatenate([
        np.linspace(0.0, 10.0, 201),
        np.logspace(1.0, 5.0, 201),
    ])
    # y: from the smallest Lorentzian/thermal ratio used by any Voigt
    # kernel (Ly-31: ~7e-5, CIV: ~2.9e-4) up to order unity
    y = np.array([7.3e-5, 2.9e-4, 4.72e-4, 1e-2, 0.5, 3.0, 9.0])
    return np.meshgrid(x, y, indexing="ij")


def test_wofz_matches_scipy_relative():
    x, y = _grid()
    ref = scipy_wofz(x + 1j * y)
    got_re, got_im = wofz_parts(x, y)

    rel_re = np.abs(np.asarray(got_re) - ref.real) / np.abs(ref.real)
    rel_im = np.abs(np.asarray(got_im) - ref.imag) / np.maximum(np.abs(ref.imag), 1e-300)
    assert np.max(rel_re) < 1e-9, np.max(rel_re)
    assert np.max(rel_im[ref.imag != 0]) < 1e-9, np.max(rel_im[ref.imag != 0])


def test_wofz_negative_x_conjugate():
    x = np.linspace(-50.0, 50.0, 101)
    y = np.full_like(x, 4.72e-4)
    ref = scipy_wofz(x + 1j * y)
    got_re, got_im = wofz_parts(x, y)
    np.testing.assert_allclose(np.asarray(got_re), ref.real, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(got_im), ref.imag, rtol=1e-9)


@pytest.mark.parametrize("sigma,gamma", [(9.08537121627923800e05, 6.06075804241938613e02),
                                         (2.5e6, 3.255002952981575e02)])
def test_voigt_profile_matches_scipy(sigma, gamma):
    v = np.linspace(-3e9, 3e9, 501)  # +-30,000 km/s in cm/s
    z = (v + 1j * gamma) / (np.sqrt(2.0) * sigma)
    ref = np.real(scipy_wofz(z)) / (np.sqrt(2.0 * np.pi) * sigma)
    got = np.asarray(voigt_profile(v, sigma, gamma))
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_wofz_float32_accuracy():
    """The f32 path (what the production pipeline runs).

    f32 rounding limits the cancellation-dominated annulus 3 < |z| < 20
    at y < 5e-4 (profile values ~1e-6 of the line core, where the
    absorption is either saturated or negligible) to ~1% relative; the
    absolute error stays at f32 epsilon and everywhere else relative
    accuracy is ~1e-6.
    """
    x, y = _grid()
    ref = scipy_wofz(x + 1j * y)
    got_re, _ = wofz_parts(x.astype(np.float32), y.astype(np.float32))
    err = np.abs(np.asarray(got_re, dtype=np.float64) - ref.real)
    rel = err / np.abs(ref.real)
    assert np.max(err) < 1e-6, np.max(err)  # absolute, units of w(0)=1
    assert np.max(rel) < 2e-2, np.max(rel)
    assert np.median(rel) < 2e-6, np.median(rel)
    # outside the annulus, relative accuracy holds
    s = np.hypot(x, y)
    good = (s < 3.0) | (s > 20.0)
    assert np.max(rel[good]) < 2e-4, np.max(rel[good])
