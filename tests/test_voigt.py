"""Voigt absorption profiles vs the reference implementation."""

import numpy as np
import pytest

from gpy_dla_detection_tpu.ops.voigt import (
    instrumental_broadening,
    voigt_absorption,
    voigt_absorption_civ,
    voigt_absorption_lls,
)

from .reference_oracle import import_reference


def _wavelength_grid(n=1200, lo=3600.0):
    # SDSS-like log-spaced grid, 1e-4 dex pixels
    return lo * 10 ** (1e-4 * np.arange(n))


@pytest.mark.parametrize(
    "z_dla,log_nhi,num_lines",
    [(2.5, 20.3, 3), (3.2, 21.8, 3), (2.1, 23.0, 1), (3.0, 20.0, 5)],
)
def test_voigt_absorption_matches_reference(z_dla, log_nhi, num_lines):
    import_reference()
    from gpy_dla_detection import voigt as ref_voigt

    wl = _wavelength_grid()
    nhi = 10.0**log_nhi
    ref = ref_voigt.voigt_absorption(wl, nhi, z_dla, num_lines=num_lines)
    got = np.asarray(voigt_absorption(wl, np.array([nhi]), np.array([z_dla]), num_lines))
    assert got.shape == (1, wl.shape[0] - 6)
    np.testing.assert_allclose(got[0], ref, atol=1e-8, rtol=1e-6)


def test_voigt_absorption_no_broadening():
    import_reference()
    from gpy_dla_detection import voigt as ref_voigt

    wl = _wavelength_grid(400)
    ref = ref_voigt.voigt_absorption(wl, 10**20.5, 2.8, num_lines=3, broadening=False)
    got = np.asarray(
        voigt_absorption(wl, np.array([10**20.5]), np.array([2.8]), 3, broadening=False)
    )
    np.testing.assert_allclose(got[0], ref, atol=1e-8, rtol=1e-6)


def test_voigt_absorption_batched_consistency():
    wl = _wavelength_grid(600)
    z = np.array([2.2, 2.5, 3.0])
    nhi = 10 ** np.array([20.1, 21.0, 22.5])
    batched = np.asarray(voigt_absorption(wl, nhi, z, 3))
    for i in range(3):
        single = np.asarray(voigt_absorption(wl, nhi[i : i + 1], z[i : i + 1], 3))
        np.testing.assert_allclose(batched[i], single[0], rtol=1e-12)


def test_voigt_lls_matches_reference():
    import_reference()
    from gpy_dla_detection import voigt_lls as ref_lls

    wl = _wavelength_grid(1500, lo=3200.0)
    nhi, z = 10**18.5, 2.7
    ref = ref_lls.voigt_absorption(wl, nhi, z, num_lines=3)
    got = np.asarray(voigt_absorption_lls(wl, np.array([nhi]), np.array([z]), 3))
    np.testing.assert_allclose(got[0], ref, atol=1e-8, rtol=1e-6)


def test_voigt_civ_matches_reference():
    import_reference()
    # the reference uses the long-removed np.float alias (voigt_civ.py:162)
    if not hasattr(np, "float"):
        np.float = np.float64
    from gpy_dla_detection import voigt_civ as ref_civ

    wl = 4700.0 * 10 ** (1e-4 * np.arange(800))
    nciv, z, sig = 10**14.0, 2.1, 2.5e6
    ref = ref_civ.voigt_absorption(wl, nciv, z, sig, num_lines=2)
    got = np.asarray(
        voigt_absorption_civ(wl, np.array([nciv]), np.array([z]), np.array([sig]), 2)
    )
    np.testing.assert_allclose(got[0], ref, atol=1e-8, rtol=1e-6)


def test_instrumental_broadening_matches_convolve():
    import_reference()
    from gpy_dla_detection.voigt import instrument_profile

    rng = np.random.default_rng(0)
    raw = rng.uniform(0.2, 1.0, size=(2, 64))
    got = np.asarray(instrumental_broadening(raw))
    for i in range(2):
        ref = np.convolve(raw[i], instrument_profile, "valid")
        np.testing.assert_allclose(got[i], ref, rtol=1e-12)


def test_voigt_preserves_float32():
    """f32 inputs must stay f32 throughout (x64 mode must not promote
    via numpy constants — regression for the instrument-profile leak)."""
    wl = _wavelength_grid(200).astype(np.float32)
    out = voigt_absorption(wl, np.float32(1e20), np.float32(2.5), 3)
    assert out.dtype == np.float32, out.dtype
    out = voigt_absorption_lls(wl, np.float32(1e18), np.float32(2.5), 3)
    assert out.dtype == np.float32
    out = voigt_absorption_civ(
        4700.0 * 10 ** (1e-4 * np.arange(100, dtype=np.float32)),
        np.float32(1e14), np.float32(2.1), np.float32(2.5e6), 2,
    )
    assert out.dtype == np.float32


@pytest.mark.parametrize("tier", [True, False])
def test_windowed_fast_path_matches_exact(tier, monkeypatch):
    """The CF+windowed-Weideman fast path must match the exact path to
    ~1e-4 on the absorption profile (f32 cancellation at the cores).

    Parametrized over the two-tier window flag (GPY_DLA_WINDOW_TIER,
    bound at import in ops/voigt.py): tier=True is the production
    default, tier=False the documented escape hatch — both must agree
    with the exact path, so neither can rot (ADVICE r3)."""
    import gpy_dla_detection_tpu.ops.voigt as voigt_mod

    monkeypatch.setattr(voigt_mod, "WINDOW_TIER", tier)
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.ops.voigt import (
        _unit_lyman_series_optical_depth,
        _unit_lyman_series_optical_depth_windowed,
    )
    from gpy_dla_detection_tpu.constants import THERMAL_SIGMA_CGS

    wl = _wavelength_grid(1200).astype(np.float32)
    rng = np.random.default_rng(0)
    z = rng.uniform(2.0, 2.9, size=64).astype(np.float32)
    nhi = (10.0 ** rng.uniform(20.0, 22.5, size=64)).astype(np.float32)

    tau_fast = nhi[:, None] * np.asarray(
        _unit_lyman_series_optical_depth_windowed(
            jnp.asarray(wl), jnp.asarray(z), 3, THERMAL_SIGMA_CGS
        )
    )
    # same-precision baseline: the windowed trick must add nothing on
    # top of the exact f32 evaluation
    tau_f32 = nhi[:, None] * np.asarray(
        _unit_lyman_series_optical_depth(
            jnp.asarray(wl), jnp.asarray(z), 3, THERMAL_SIGMA_CGS
        )
    )
    err32 = np.abs(
        np.exp(-tau_fast.astype(np.float64)) - np.exp(-tau_f32.astype(np.float64))
    )
    assert err32.max() < 5e-5, err32.max()

    # vs f64 ground truth: bounded by the intrinsic f32 Faddeeva annulus
    # error (~1e-3 on the profile at tau-of-order-1 pixels near a core)
    tau_exact = nhi[:, None].astype(np.float64) * np.asarray(
        _unit_lyman_series_optical_depth(
            jnp.asarray(wl, jnp.float64),
            jnp.asarray(z, jnp.float64),
            3,
            THERMAL_SIGMA_CGS,
        )
    )
    err = np.abs(np.exp(-tau_fast.astype(np.float64)) - np.exp(-tau_exact))
    assert err.max() < 5e-3, err.max()
    assert np.median(err) < 1e-6


@pytest.mark.parametrize("tier", [True, False])
def test_windowed_center_estimate_irregular_grid(tier, monkeypatch):
    """The f32 windowed path locates each line-center window by a
    chunk-level count plus a LINEAR within-chunk estimate (no
    searchsorted, no gather — ops/voigt.py).  On the log-uniform SDSS
    grid the estimate is exact to ~0.01 px; this pins the robustness
    margin on a STRESSED grid whose per-pixel log-spacing is jittered
    by ±30% (far rougher than any masked/cut SDSS grid): the window
    must still cover every core, i.e. windowed == exact-f32 to the
    usual tolerance, including at the sampler's logNHI ceiling.
    Parametrized over the two-tier window flag (ADVICE r3)."""
    import gpy_dla_detection_tpu.ops.voigt as voigt_mod

    monkeypatch.setattr(voigt_mod, "WINDOW_TIER", tier)
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.constants import THERMAL_SIGMA_CGS
    from gpy_dla_detection_tpu.ops.voigt import (
        _unit_lyman_series_optical_depth,
        _unit_lyman_series_optical_depth_windowed,
    )

    rng = np.random.default_rng(5)
    dlog = 1e-4 * rng.uniform(0.7, 1.3, size=1200)
    wl = (3600.0 * 10 ** np.concatenate([[0.0], np.cumsum(dlog[:-1])])).astype(
        np.float32
    )
    z = rng.uniform(2.0, 2.9, size=48).astype(np.float32)
    nhi = (10.0 ** rng.uniform(20.0, 23.0, size=48)).astype(np.float32)

    tau_fast = nhi[:, None] * np.asarray(
        _unit_lyman_series_optical_depth_windowed(
            jnp.asarray(wl), jnp.asarray(z), 3, THERMAL_SIGMA_CGS
        )
    )
    tau_f32 = nhi[:, None] * np.asarray(
        _unit_lyman_series_optical_depth(
            jnp.asarray(wl), jnp.asarray(z), 3, THERMAL_SIGMA_CGS
        )
    )
    err = np.abs(
        np.exp(-tau_fast.astype(np.float64))
        - np.exp(-tau_f32.astype(np.float64))
    )
    assert err.max() < 5e-5, err.max()


def test_windowed_far_field_truncation_all_lines():
    """With the full 31-line series at the sampler's logNHI ceiling,
    the windowed path's far-field reductions (direct Lorentzian rational
    + no far field beyond FAR_FIELD_LINES) must stay within the f32
    windowed-path error budget vs the exact f64 evaluation
    (ops/voigt.py FAR_FIELD_LINES bound)."""
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.constants import THERMAL_SIGMA_CGS
    from gpy_dla_detection_tpu.ops.voigt import (
        _unit_lyman_series_optical_depth,
        _unit_lyman_series_optical_depth_windowed,
    )

    wl = _wavelength_grid(1200).astype(np.float32)
    rng = np.random.default_rng(5)
    # z high enough that the upper series lands on the grid; NHI at the
    # top of the sampled range where the dropped far wings are largest
    z = rng.uniform(2.5, 2.9, size=16).astype(np.float32)
    nhi = (10.0 ** rng.uniform(22.5, 23.0, size=16)).astype(np.float32)

    tau_fast = nhi[:, None] * np.asarray(
        _unit_lyman_series_optical_depth_windowed(
            jnp.asarray(wl), jnp.asarray(z), 31, THERMAL_SIGMA_CGS
        )
    )
    # same-precision baseline: isolates the windowed-path reductions
    # from the intrinsic f32 core-cancellation error (the plain exact
    # f32 evaluation itself reaches ~1.7e-2 vs f64 at a saturated core
    # pixel at these columns — measured identical with and without the
    # far-field reductions)
    tau_f32 = nhi[:, None] * np.asarray(
        _unit_lyman_series_optical_depth(
            jnp.asarray(wl), jnp.asarray(z), 31, THERMAL_SIGMA_CGS
        )
    )
    err32 = np.abs(
        np.exp(-tau_fast.astype(np.float64))
        - np.exp(-tau_f32.astype(np.float64))
    )
    assert err32.max() < 5e-5, err32.max()

    tau_exact = nhi[:, None].astype(np.float64) * np.asarray(
        _unit_lyman_series_optical_depth(
            jnp.asarray(wl, jnp.float64),
            jnp.asarray(z, jnp.float64),
            31,
            THERMAL_SIGMA_CGS,
        )
    )
    err = np.abs(np.exp(-tau_fast.astype(np.float64)) - np.exp(-tau_exact))
    assert err.max() < 2e-2, err.max()  # f32 core cancellation bound
    assert np.median(err) < 1e-6, np.median(err)


def test_windowed_parts_placement():
    """The unplaced windowed-tau parts, placed by the dense chunk
    broadcast, reproduce the dense windowed path exactly, and the
    absorption tail of the placed tau is exp + 7-tap broadening."""
    import jax.numpy as jnp

    from gpy_dla_detection_tpu import constants as C
    from gpy_dla_detection_tpu.ops.voigt import (
        _place_windows,
        _unit_lyman_series_optical_depth_windowed,
        _windowed_tau_parts,
        absorption_from_unit_tau,
    )

    rng = np.random.default_rng(2)
    P = 300
    wl = jnp.asarray(
        (1215.67 * 3.9 * 10 ** (1e-4 * np.arange(P))).astype(np.float32)
    )
    S = 24
    z = jnp.asarray(rng.uniform(2.9, 3.8, S).astype(np.float32))
    nhi = jnp.asarray(10 ** rng.uniform(20, 21.5, S).astype(np.float32))

    dense = _unit_lyman_series_optical_depth_windowed(
        wl, z, 3, C.THERMAL_SIGMA_CGS
    )
    parts = _windowed_tau_parts(wl, z, 3, C.THERMAL_SIGMA_CGS)
    assert parts.far.shape == (S, 384) and parts.c0.shape == (S, 3)
    np.testing.assert_allclose(
        np.asarray(_place_windows(parts)), np.asarray(dense), rtol=0, atol=0
    )
    want = instrumental_broadening(jnp.exp(-nhi[:, None] * dense))
    np.testing.assert_allclose(
        np.asarray(absorption_from_unit_tau(dense, nhi)), np.asarray(want),
        rtol=2e-6, atol=1e-7,
    )


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("impl", [None, "exact", "windowed"])
def test_voigt_impl_choice_is_keyed_on_dtype(dtype, impl):
    """The Voigt strategy follows the explicit choice and the dtype, and
    nothing else: None means the exact blend, and the windowed variant
    is an f32 fast path that f64 (the reference dtype) resolves to
    exact."""
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.ops.kernel_config import resolve_voigt_impl

    x = jnp.zeros(4, dtype)
    want = "windowed" if (impl == "windowed" and dtype == "float32") else "exact"
    assert resolve_voigt_impl(impl, x) == want
    # and the profile follows it: the windowed f32 path differs from the
    # exact one in the far wings, every other combination is the exact
    # path bit for bit
    wl = jnp.asarray(_wavelength_grid(300, 4200.0), dtype)
    z = jnp.asarray([2.5, 2.6], dtype)
    nhi = jnp.asarray([1e20, 3e20], dtype)
    got = np.asarray(voigt_absorption(wl, nhi, z, 3, impl=impl))
    exact = np.asarray(voigt_absorption(wl, nhi, z, 3, impl="exact"))
    if want == "exact":
        np.testing.assert_array_equal(got, exact)
    else:
        assert not np.array_equal(got, exact)
        np.testing.assert_allclose(got, exact, rtol=0, atol=2e-3)


def test_voigt_impl_rejects_unknown():
    from gpy_dla_detection_tpu.ops.kernel_config import resolve_voigt_impl

    with pytest.raises(ValueError, match="voigt impl"):
        resolve_voigt_impl("pallas", np.zeros(2, np.float32))


@pytest.mark.parametrize(
    "choice,dtype,num_pixels,want",
    [
        (None, "float32", 1280, None),
        ("f32", "float32", 1280, None),
        ("i16", "float32", 1280, "int16"),
        ("i16p", "float32", 1280, "int32"),
        ("i16p", "float32", 1279, "int16"),  # packed pairs need even N
        ("float64", "float64", 1280, None),
        ("float32", "float64", 1280, "float32"),
    ],
)
def test_profile_store_choice(choice, dtype, num_pixels, want):
    """Profile storage is an explicit choice, resolved against the
    pipeline dtype and the pixel count (None = keep the dtype)."""
    from gpy_dla_detection_tpu.ops.kernel_config import resolve_abs_store

    got = resolve_abs_store(choice, np.dtype(dtype), num_pixels)
    assert (None if got is None else np.dtype(got).name) == want
