"""Batched Voigt absorption profiles.

Batched rewrite of the reference Voigt kernels (reference:
gpy_dla_detection/voigt.py:251-322, voigt_lls.py:287-363,
voigt_civ.py:103-175, voigt.c:253-304).  Design differences:

* batched over absorbers: ``nhi``/``z_absorber`` carry a leading sample
  axis and the profile is computed for all samples in one fused
  elementwise pipeline (the reference evaluates one absorber at a time
  inside a Python/parfor loop);
* the Faddeeva function is evaluated natively (ops/faddeeva.py) instead
  of calling scipy/libcerf;
* the relative velocity is computed as ``c * (lambda - lambda_c) /
  lambda_c`` instead of the reference's ``lambda * c / lambda_c - c``,
  avoiding catastrophic cancellation in float32;
* the 7-tap instrumental convolution is an unrolled shifted-sum (XLA
  fuses it with the exp) instead of ``np.convolve``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from .faddeeva import RADIUS, _wofz_cf, _wofz_weideman, wofz_parts
from .interp import chunked_searchsorted
from .kernel_config import ABS_I16_SCALE, WINDOW_TIER, resolve_voigt_impl

SQRT_2PI = 2.5066282746310002

# the windowed fast path aligns per-line windows to 128-pixel chunks;
# the |z| <= RADIUS core spans only ~±1.3 px at SDSS resolution
CHUNK = 128  # window alignment
FAST_WINDOW = 256  # two aligned chunks per window
# beyond this |z| the K=1 continued fraction truncation error is
# ~1/(2|z|^4) ~ 2e-10 — far below f32 rounding; the 7 < |z| <= 256
# annulus spans ~±48 px (1 px ~ 5.4 |z| units at SDSS resolution),
# inside the window's guaranteed ±64 px margin, where the full-K
# correction is applied
CF_FAR_RADIUS = 256.0

# far-field (|z| > CF_FAR_RADIUS) evaluation runs only for the first
# FAR_FIELD_LINES Lyman lines: line l's far tau is bounded by
# N amp_l y_l / (sqrt(pi) CF_FAR_RADIUS^2), and the lines beyond 16 sum
# to < 5e-5 absorption at the sampler's logNHI ceiling of 23 (their
# cores/annuli remain exact via the per-line 256-pixel windows).  The
# dense/exact path is unaffected — it is the conformance oracle.
FAR_FIELD_LINES = 16


def instrumental_broadening(raw):
    """Valid-mode convolution with the 7-tap SDSS instrument profile.

    ``raw``: (..., P) -> (..., P - 6).
    (reference: gpy_dla_detection/voigt.py:311-320)
    """
    taps = jnp.asarray(C.INSTRUMENT_PROFILE, raw.dtype)
    width = C.INSTRUMENT_PROFILE_HALF_WIDTH
    P = raw.shape[-1]
    out = taps[0] * raw[..., : P - 2 * width]
    for k in range(1, 2 * width + 1):
        out = out + taps[k] * raw[..., k : P - 2 * width + k]
    return out


def _unit_lyman_series_optical_depth(wavelengths, z_absorber, num_lines, sigma):
    """Summed Lyman-series optical depth tau(lambda) per unit column
    density: the Faddeeva-dependent factor of ``tau = nhi * unit_tau``.
    nhi enters the profile only as this outer scale, so one evaluation
    serves every column-density family sharing the z samples.

    wavelengths: (P,) observed wavelengths [A]
    z_absorber: (...,) absorber redshift
    returns: (..., P)
    """
    dtype = wavelengths.dtype
    one_plus_z = (1.0 + z_absorber)[..., None]  # (..., 1)
    tau = None
    for l in range(num_lines):
        lam_l = jnp.asarray(C.LYMAN_WAVELENGTHS_A[l], dtype)
        lead_l = jnp.asarray(C.LYMAN_LEADING_CONSTANTS[l], dtype)
        gam_l = jnp.asarray(C.LYMAN_LORENTZIAN_WIDTHS[l], dtype)
        lam_c = lam_l * one_plus_z  # line center, observed frame (..., 1)
        # velocity in cm/s, cancellation-free form
        velocity = (wavelengths - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
        inv = 1.0 / (jnp.sqrt(jnp.asarray(2.0, dtype)) * sigma)
        w_re, _ = wofz_parts(velocity * inv, gam_l * inv)
        contrib = (lead_l * inv / jnp.asarray(jnp.sqrt(jnp.pi), dtype)) * w_re
        tau = contrib if tau is None else tau + contrib
    return tau


class WindowedTauParts(NamedTuple):
    """Windowed unit optical depth in unplaced form: the cheap far field
    on the chunk-padded pixel grid plus per-line window corrections with
    their chunk-aligned start indices (placed by :func:`_place_windows`).
    """

    far: jnp.ndarray  # (S, P_pad) far-field tau (chunk-padded pixels)
    corr: jnp.ndarray  # (S, L * FAST_WINDOW) per-line window corrections
    c0: jnp.ndarray  # (S, L) int32 chunk index of each window start
    num_pixels: int  # original (unpadded) pixel count P


def chunk_pad_wavelengths(wavelengths):
    """Pad a (P,) wavelength grid to a multiple of CHUNK pixels,
    continuing the grid's local spacing instead of edge-repeating:
    the f32 fast path estimates each line-center pixel by a LINEAR
    within-chunk map from the chunk endpoints, and an edge-padded
    partial last chunk compresses its wavelength span (48 real pixels
    mapped onto 128 slots put the estimate 43 px off in the tier
    stress test — beyond the strip's ±32-px coverage, so the Weideman
    core went missing).  Padded positions' far field and corrections
    land beyond P and are sliced off by the placement
    (_place_windows), so only the estimate geometry matters."""
    dtype = wavelengths.dtype
    P = wavelengths.shape[0]
    nc = -(-P // CHUNK)
    P_pad = nc * CHUNK
    if P_pad > P:
        step = wavelengths[-1] - wavelengths[-2]
        step = jnp.where(step > 0, step, jnp.ones_like(step))
        ext = wavelengths[-1] + step * jnp.arange(
            1, P_pad - P + 1, dtype=dtype
        )
        return jnp.concatenate([wavelengths, ext])
    return wavelengths


def _windowed_tau_parts(wavelengths, z_absorber, num_lines, sigma):
    """Far field + window corrections of the windowed unit tau, without
    the placement (see :func:`_place_windows` /
    :class:`WindowedTauParts`)."""
    dtype = wavelengths.dtype
    S = z_absorber.shape[0]
    P = wavelengths.shape[0]
    CH = CHUNK
    inv = 1.0 / (jnp.sqrt(jnp.asarray(2.0, dtype)) * sigma)
    c_over = jnp.asarray(C.SPEED_OF_LIGHT_CGS, dtype)

    one_plus_z = (1.0 + z_absorber)[:, None]  # (S, 1)

    nc = -(-P // CH)
    P_pad = nc * CH
    wl_pad = chunk_pad_wavelengths(wavelengths)
    wl_chunks = wl_pad.reshape(nc, CH)

    # f32 fast path for the window start: the line-center pixel index is
    # computed by a chunk-level count plus a LINEAR within-chunk
    # estimate from the chunk endpoints — on the log-uniform SDSS grid
    # the curvature error is ~0.01 px, and the window placement
    # tolerates ~±15 px (the CF_FAR_RADIUS annulus spans ±48 px inside
    # the window's ±64 px margin).  The f64 path (the conformance
    # oracle's dtype) keeps the exact searchsorted.
    f32fast = dtype == jnp.float32
    # each window covers chunks (c0, c0 + 1): one row of this table
    pairs = jnp.concatenate([wl_chunks[:-1], wl_chunks[1:]], axis=1)
    if f32fast:
        tops = wl_chunks[:, -1]  # (nc,)
        firsts = wl_chunks[:, 0]
        j_chunk = jnp.arange(nc, dtype=jnp.int32)

    far = jnp.zeros((S, P_pad), dtype)
    corrs = []
    c0s = []
    for l in range(num_lines):
        lam_l = jnp.asarray(C.LYMAN_WAVELENGTHS_A[l], dtype)
        lead_l = jnp.asarray(C.LYMAN_LEADING_CONSTANTS[l], dtype)
        gam_l = jnp.asarray(C.LYMAN_LORENTZIAN_WIDTHS[l], dtype)
        amp = lead_l * inv / jnp.asarray(jnp.sqrt(jnp.pi), dtype)
        lam_c = lam_l * one_plus_z  # line center, observed frame (S, 1)
        y_l = gam_l * inv

        # far wings over all pixels as the direct Lorentzian rational
        # Re w(x+iy) ~ y / (sqrt(pi) (x^2+y^2)): beyond CF_FAR_RADIUS
        # this differs from w by <= 1/(2|z|^2) ~ 7.6e-6 relative (the
        # first dropped CF term), below every other f32 error in the
        # pipeline, at a third of the K=1 CF arithmetic.  The window
        # pass supplies the exact value inside CF_FAR_RADIUS.  Lines
        # >= FAR_FIELD_LINES skip the far field entirely: their far
        # tau at the radius-256 boundary is <= amp_l y_l /
        # (sqrt(pi) 256^2), which summed over the dropped lines is
        # < 5e-5 absorption even at logNHI = 23 (their saturated cores
        # and annuli stay exact through the per-line windows).
        if l < FAR_FIELD_LINES:
            x_all = (wl_pad - lam_c) * (c_over / lam_c) * inv  # (S, P_pad)
            r2_all = x_all * x_all + y_l * y_l
            far_all = r2_all > CF_FAR_RADIUS * CF_FAR_RADIUS
            w_far = y_l / (jnp.sqrt(jnp.asarray(jnp.pi, dtype)) * r2_all)
            far = far + amp * jnp.where(far_all, w_far, 0.0)

        # chunk-aligned window start per row (see the windowed fn)
        if f32fast:
            q = lam_c[:, 0]  # (S,)
            c_idx = jnp.clip(
                jnp.sum(q[:, None] >= tops[None, :], axis=1).astype(jnp.int32),
                0,
                nc - 1,
            )
            sel_c = c_idx[:, None] == j_chunk[None, :]  # (S, nc)
            first = jnp.sum(jnp.where(sel_c, firsts[None, :], 0.0), axis=1)
            last = jnp.sum(jnp.where(sel_c, tops[None, :], 0.0), axis=1)
            within = jnp.clip(
                (q - first) / jnp.maximum(last - first, 1e-30) * (CH - 1),
                0.0,
                CH - 1.0,
            )
            center = c_idx * CH + within.astype(jnp.int32)
        else:
            center = chunked_searchsorted(wavelengths, lam_c[:, 0])
        c0 = jnp.clip((center - CH // 2) // CH, 0, nc - 2)  # (S,)
        wl_win = jnp.take(pairs, c0, axis=0, mode="clip")  # (S, W)

        x_win = (wl_win - lam_c) * (c_over / lam_c) * inv
        ax = jnp.abs(x_win)
        r2 = ax * ax + y_l * y_l
        if f32fast and WINDOW_TIER:
            # Two-tier evaluation: the expensive pieces (20-term
            # Weideman Horner for |z| <= RADIUS, full-K CF for the
            # near annulus) run only on a 96-px strip of three
            # 32-px blocks around the line-center estimate; the rest
            # of the window uses the 2-term CF (truncation error
            # ~1.6e-7 relative at |z| = 20 and falling as |z|^-4 —
            # the strip guarantees ±32 px of coverage around the
            # estimate, so tier-2 pixels sit beyond |z| ~ 59 even
            # with the ±15 px placement tolerance and 30% grid
            # jitter).  This halves the arithmetic of the window
            # pass.
            SB = 32
            nb = FAST_WINDOW // SB  # 8 blocks per window
            blocks = ax.reshape(S, nb, SB)
            lc_local = center - c0 * CH  # estimated center within window
            b_strip = jnp.clip(lc_local // SB - 1, 0, nb - 3)  # (S,)
            jb = jnp.arange(nb, dtype=jnp.int32)
            # extract the 3-block strip (exact: 0/1 masked sums with
            # exactly one nonzero term per output)
            sels = [
                (jb[None, :] == (b_strip + off)[:, None]) for off in range(3)
            ]
            ax_strip = jnp.concatenate(
                [
                    jnp.sum(jnp.where(s[:, :, None], blocks, 0.0), axis=1)
                    for s in sels
                ],
                axis=1,
            )  # (S, 3 SB)
            y_strip = jnp.full_like(ax_strip, y_l)
            r2_s = ax_strip * ax_strip + y_l * y_l
            inner_s = r2_s <= RADIUS * RADIUS
            ann_s = (~inner_s) & (r2_s <= CF_FAR_RADIUS * CF_FAR_RADIUS)
            wei_s, _ = _wofz_weideman(
                jnp.where(inner_s, ax_strip, 0.0), y_strip
            )
            cf_s, _ = _wofz_cf(ax_strip, y_strip)  # full K
            strip_val = jnp.where(inner_s, wei_s, 0.0) + jnp.where(
                ann_s, cf_s, 0.0
            )  # (S, 3 SB)
            # 2-term CF over the whole window; masked off inside the
            # strip (the strip supplies those pixels exactly)
            cf2, _ = _wofz_cf(ax, jnp.full_like(x_win, y_l), terms=2)
            sv = strip_val.reshape(S, 3, SB)
            placed = jnp.zeros_like(blocks)
            in_strip = jnp.zeros((S, nb), dtype=bool)
            for off, s in enumerate(sels):
                placed = placed + jnp.where(
                    s[:, :, None], sv[:, off][:, None, :], 0.0
                )
                in_strip = in_strip | s
            # exclude the |z| <= RADIUS Weideman disk as well: when the
            # placement is correct the strip covers the disk and this
            # clause never fires (zero cost), but if the line-center
            # estimate ever errs beyond the strip guarantee (e.g. a
            # masked gap breaking the within-chunk linear estimate),
            # in-disk pixels would otherwise receive in-disk 2-term-CF
            # values — garbage-but-finite, possibly NEGATIVE tau and
            # absorption > 1.  With the disk excluded, gross
            # misplacement degrades like the non-tier baseline (a
            # missing correction) instead of injecting garbage.
            r2_blocks = r2.reshape(S, nb, SB)
            mid = (
                (~in_strip[:, :, None])
                & (r2_blocks <= CF_FAR_RADIUS * CF_FAR_RADIUS)
                & (r2_blocks > RADIUS * RADIUS)
            )
            cf2_blocks = cf2.reshape(S, nb, SB)
            corr_l = (
                placed + jnp.where(mid, cf2_blocks, 0.0)
            ).reshape(S, FAST_WINDOW)
            corrs.append(amp * corr_l)
        else:
            inner = r2 <= RADIUS * RADIUS
            annulus = (~inner) & (r2 <= CF_FAR_RADIUS * CF_FAR_RADIUS)
            wei_win, _ = _wofz_weideman(
                jnp.where(inner, ax, 0.0), jnp.full_like(x_win, y_l)
            )
            cf_win, _ = _wofz_cf(ax, jnp.full_like(x_win, y_l))  # full K
            corrs.append(
                amp
                * (
                    jnp.where(inner, wei_win, 0.0)
                    + jnp.where(annulus, cf_win, 0.0)
                )
            )  # (S, W)
        c0s.append(c0.astype(jnp.int32))

    return WindowedTauParts(
        far=far,
        corr=jnp.concatenate(corrs, axis=1),
        c0=jnp.stack(c0s, axis=1),
        num_pixels=P,
    )


def _place_windows(parts: WindowedTauParts):
    """Placement of the window corrections: dense chunk broadcast (no
    scatter, no per-row dynamic slices — see the windowed fn's
    docstring).  Returns the dense (S, P) unit tau."""
    far, corr, c0_all, P = parts
    S, P_pad = far.shape
    CH = CHUNK
    W = FAST_WINDOW
    nc = P_pad // CH
    j_idx = jnp.arange(nc, dtype=jnp.int32)
    dtype = far.dtype

    tau = far
    L = c0_all.shape[1]
    for l in range(L):
        corr_l = corr[:, l * W : (l + 1) * W]
        c0 = c0_all[:, l]
        sel0 = (c0[:, None] == j_idx[None, :]).astype(dtype)  # (S, nc)
        sel1 = (c0[:, None] + 1 == j_idx[None, :]).astype(dtype)
        place = (
            sel0[:, :, None] * corr_l[:, None, :CH]
            + sel1[:, :, None] * corr_l[:, None, CH:]
        )  # (S, nc, CH)
        tau = tau + place.reshape(S, P_pad)
    return tau[:, :P]


def _unit_lyman_series_optical_depth_windowed(
    wavelengths, z_absorber, num_lines, sigma
):
    """Fast path: continued-fraction Faddeeva everywhere plus the exact
    (Weideman) evaluation on a 256-pixel window around each line center
    -- the only pixels whose |z| can fall inside the rational
    approximation's disk (the core spans ~+-2 pixels at SDSS
    resolution, so a chunk-aligned 2x128-pixel window always covers it).

    The window placement is a *dense chunk broadcast*: with the pixel
    axis viewed as (n_chunks, 128) and window starts aligned to chunk
    boundaries, each row's correction lands in chunks (c0, c0+1), so

        tau += (c0 == j) * corr[:128] + (c0 + 1 == j) * corr[128:]

    broadcast over the chunk index j builds the full correction in one
    fused elementwise expression -- no scatter, no per-row dynamic
    slices, and no masked .at[].add chain (which would round-trip the
    full tau through device memory per candidate start).
    """
    return _place_windows(
        _windowed_tau_parts(wavelengths, z_absorber, num_lines, sigma)
    )


def unit_lyman_optical_depth(
    wavelengths,
    z_absorber,
    num_lines: int = 3,
    sigma: float = C.THERMAL_SIGMA_CGS,
    impl: str | None = None,
):
    """Per-unit-column-density Lyman-series optical depth: the expensive
    (Faddeeva) factor of a Voigt profile, which depends on the absorber
    redshift but NOT on nhi.  ``tau = nhi * unit_tau``; see
    :func:`absorption_from_unit_tau`.

    This is the sharing point between the DLA and subDLA models: the
    reference draws both models' redshifts from the *same* Halton
    dimension (reference: multi_dlas/set_lls_parameters.m:22,59 — only
    the logNHI dimension differs), so one unit-tau evaluation serves
    both QMC marginalizations.
    """
    z_absorber = jnp.asarray(z_absorber)
    impl = resolve_voigt_impl(impl, wavelengths)
    if (
        impl == "windowed"
        and z_absorber.ndim == 1
        and wavelengths.ndim == 1
        and sigma == C.THERMAL_SIGMA_CGS
    ):
        return _unit_lyman_series_optical_depth_windowed(
            wavelengths, z_absorber, num_lines, sigma
        )
    tau = _unit_lyman_series_optical_depth(
        wavelengths, z_absorber, num_lines, sigma
    )
    return tau


def absorption_from_unit_tau(
    unit_tau, nhi, broadening: bool = True, out_dtype=None
):
    """Broadened absorption profile from a precomputed unit optical
    depth: ``conv(exp(-nhi * unit_tau))``.  The cheap (exp + 7-tap
    conv) tail of :func:`voigt_absorption`, reusable across
    column-density families.

    :param out_dtype: storage dtype of the result (None = the input
        dtype; see :func:`encode_profile_store`).  The math stays in the
        input dtype and only the final store quantizes.
    """
    nhi = jnp.asarray(nhi)
    raw = jnp.exp(-nhi[..., None] * unit_tau)
    out = instrumental_broadening(raw) if broadening else raw
    return encode_profile_store(out, out_dtype)


def encode_profile_store(out, out_dtype):
    """Profile-storage encoder: float dtypes verbatim, int16 fixed-point
    codes, int32 packed i16-pair codes (ops/kernel_config.py)."""
    if out_dtype is None:
        return out
    dt = jnp.dtype(out_dtype)
    if dt == jnp.int16:
        out = jnp.round(out * ABS_I16_SCALE)
    elif dt == jnp.int32:
        v = jnp.round(out * ABS_I16_SCALE).astype(jnp.int32)
        h = v.shape[-1] // 2
        if v.shape[-1] % 2:
            raise ValueError(
                "packed i16-pair storage needs an even pixel count, "
                f"got {v.shape[-1]}"
            )
        return v[..., :h] | (v[..., h:] << 16)
    return out.astype(out_dtype)


def decode_profile_store(x, dtype):
    """Inverse of :func:`encode_profile_store`: stored profiles back to
    ``dtype`` (exact for float storage; the fixed-point grid otherwise)."""
    if x.dtype == jnp.int16:
        return x.astype(dtype) * (1.0 / ABS_I16_SCALE)
    if x.dtype == jnp.int32:
        lo = (x & 0xFFFF).astype(dtype)
        hi = (x >> 16).astype(dtype)
        return jnp.concatenate([lo, hi], axis=-1) * (1.0 / ABS_I16_SCALE)
    return x.astype(dtype)


def voigt_absorption(
    wavelengths,
    nhi,
    z_absorber,
    num_lines: int = 3,
    broadening: bool = True,
    sigma: float = C.THERMAL_SIGMA_CGS,
    impl: str | None = None,
):
    """Absorption profile exp(-tau) of one absorber per sample.

    :param wavelengths: (P,) observed (padded) wavelengths [A].
    :param nhi: (...,) HI column densities [cm^-2].
    :param z_absorber: (...,) absorber redshifts.
    :param impl: evaluation strategy (static; ops/kernel_config.py):
        None or "exact" = full Weideman+CF blend at every pixel,
        "windowed" = f32 far-field rational plus the exact blend on a
        chunk-aligned 256-px window per line (agrees with "exact" to
        ~1e-4 relative in log evidence).  The windowed path requires
        f32, 1-D inputs and the default thermal sigma (the window sizing
        assumes it) and falls back to "exact" otherwise.
    :return: (..., P - 6) if ``broadening`` else (..., P).
    (reference: gpy_dla_detection/voigt.py:251-322)
    """
    nhi = jnp.asarray(nhi)
    z_absorber = jnp.asarray(z_absorber)
    impl = resolve_voigt_impl(impl, wavelengths)
    structured = (
        z_absorber.ndim == 1
        and wavelengths.ndim == 1
        and sigma == C.THERMAL_SIGMA_CGS
    )
    if impl == "windowed" and structured:
        unit = _unit_lyman_series_optical_depth_windowed(
            wavelengths, z_absorber, num_lines, sigma
        )
    else:
        unit = _unit_lyman_series_optical_depth(
            wavelengths, z_absorber, num_lines, sigma
        )
    return absorption_from_unit_tau(unit, nhi, broadening)


def voigt_absorption_lls(
    wavelengths,
    nhi,
    z_absorber,
    num_lines: int = 3,
    broadening: bool = True,
    sigma: float = C.THERMAL_SIGMA_CGS,
    impl: str | None = None,
):
    """Absorption profile including the Lyman-limit break opacity.

    Adds ``tau_break = nhi / 10^17.2 * (lambda_rest / 911.7641)^3`` for
    rest wavelengths below the Lyman limit.
    (reference: gpy_dla_detection/voigt_lls.py:254-363)
    """
    lambda_lyman_limit = 911.7641
    nhi = jnp.asarray(nhi)
    z_absorber = jnp.asarray(z_absorber)
    impl = resolve_voigt_impl(impl, wavelengths)
    if (
        impl == "windowed"
        and z_absorber.ndim == 1
        and wavelengths.ndim == 1
        and sigma == C.THERMAL_SIGMA_CGS
    ):
        tau = nhi[..., None] * _unit_lyman_series_optical_depth_windowed(
            wavelengths, z_absorber, num_lines, sigma
        )
    else:
        tau = nhi[..., None] * _unit_lyman_series_optical_depth(
            wavelengths, z_absorber, num_lines, sigma
        )
    rest = wavelengths / (1.0 + z_absorber)[..., None]
    tau_break = jnp.where(
        rest > lambda_lyman_limit,
        0.0,
        nhi[..., None] / 10**17.2 * (rest / lambda_lyman_limit) ** 3,
    )
    raw = jnp.exp(-(tau + tau_break))
    if broadening:
        return instrumental_broadening(raw)
    return raw


def voigt_absorption_civ(
    wavelengths,
    nciv,
    z_civ,
    sigma,
    num_lines: int = 2,
    broadening: bool = True,
):
    """CIV doublet absorption; the broadening velocity ``sigma`` is a free
    parameter per sample (reference: gpy_dla_detection/voigt_civ.py:103-175).

    :param nciv, z_civ, sigma: (...,) per-sample parameters.
    """
    dtype = jnp.asarray(wavelengths).dtype
    nciv = jnp.asarray(nciv)
    z_civ = jnp.asarray(z_civ)
    sigma = jnp.asarray(sigma)[..., None]
    one_plus_z = (1.0 + z_civ)[..., None]
    tau = None
    for l in range(num_lines):
        lam_l = jnp.asarray(C.CIV_WAVELENGTHS_CM[l] * 1e8, dtype)
        lead_l = jnp.asarray(C.CIV_LEADING_CONSTANTS[l], dtype)
        gam_l = jnp.asarray(C.CIV_LORENTZIAN_WIDTHS[l], dtype)
        lam_c = lam_l * one_plus_z
        velocity = (wavelengths - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
        inv = 1.0 / (jnp.sqrt(jnp.asarray(2.0, dtype)) * sigma)
        w_re, _ = wofz_parts(velocity * inv, gam_l * inv)
        contrib = (lead_l / jnp.asarray(jnp.sqrt(jnp.pi), dtype)) * inv * w_re
        tau = contrib if tau is None else tau + contrib
    raw = jnp.exp(-nciv[..., None] * tau)
    if broadening:
        return instrumental_broadening(raw)
    return raw
