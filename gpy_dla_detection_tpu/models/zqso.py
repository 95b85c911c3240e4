"""Quasar redshift estimation with a GP prior over the emission spectrum.

Batched rewrite of the reference's ``ZGP`` (reference:
gpy_dla_detection/zqso_gp.py:14-319).  The reference re-runs its
stateful ``set_data`` (re-window, re-normalize, re-interpolate) once
per candidate redshift in a 10,000-iteration Python loop
(zqso_gp.py:231-243); here the whole scan is one fixed-shape,
mask-recomputed evaluation vmapped over the redshift grid and processed
in chunks to bound memory.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.interp import interp_uniform
from ..ops.logmvn import LOG_2PI, log_mvnpdf_low_rank
from ..params import ZParameters
from ..utils.memo import memo_by_identity


class ZLearnedModel(NamedTuple):
    """Trained zQSO GP (reference: zqso_gp.py:36-64, ZGPMAT:288-319)."""

    rest_wavelengths: np.ndarray  # (R,)
    mu: np.ndarray  # (R,)
    M: np.ndarray  # (R, k)
    bluewards_mu: np.ndarray  # scalar
    bluewards_sigma: np.ndarray  # scalar
    redwards_mu: np.ndarray  # scalar
    redwards_sigma: np.ndarray  # scalar

    def astype(self, dtype):
        return ZLearnedModel(*[jnp.asarray(f, dtype) for f in self])


class ZSpectrum(NamedTuple):
    """A full observed spectrum, fixed-shape (no windowing yet —
    windows depend on the candidate redshift)."""

    wavelengths: jnp.ndarray  # (P,)
    flux: jnp.ndarray  # (P,)
    noise_variance: jnp.ndarray  # (P,)
    valid: jnp.ndarray  # (P,) bool: real, unmasked pixel


def prepare_z_spectrum(
    wavelengths, flux, noise_variance, pixel_mask, num_pixels: int | None = None
) -> ZSpectrum:
    """Pad one observed spectrum to a fixed pixel count (host-side).

    ``num_pixels`` defaults to ``ZParameters.num_pixels_padded`` — the
    single source of truth for the zQSO padding size.
    """
    if num_pixels is None:
        num_pixels = ZParameters().num_pixels_padded
    wavelengths = np.asarray(wavelengths, np.float64)
    flux = np.asarray(flux, np.float64)
    noise_variance = np.asarray(noise_variance, np.float64)
    pixel_mask = np.asarray(pixel_mask, bool)

    n = wavelengths.shape[0]
    if n > num_pixels:
        raise ValueError(f"spectrum has {n} > {num_pixels} pixels")
    # infinite/NaN variances are unusable pixels (reference kludges them
    # to the mean, zqso_gp.py:177; masking is cleaner)
    bad = pixel_mask | ~np.isfinite(noise_variance) | ~np.isfinite(flux)

    wl = np.full(num_pixels, wavelengths[-1] if n else 1.0)
    fx = np.zeros(num_pixels)
    nv = np.ones(num_pixels)
    valid = np.zeros(num_pixels, bool)
    wl[:n] = wavelengths
    fx[:n] = np.where(bad, 0.0, np.nan_to_num(flux))
    nv[:n] = np.where(bad, 1.0, np.nan_to_num(noise_variance, nan=1.0))
    valid[:n] = ~bad
    return ZSpectrum(wl, fx, nv, valid)


def _masked_median(values, mask):
    """Median over masked entries (fixed shape)."""
    big = jnp.asarray(jnp.inf, values.dtype)
    x = jnp.sort(jnp.where(mask, values, big))
    n = jnp.sum(mask)
    hi = jnp.clip((n // 2), 0, x.shape[0] - 1)
    lo = jnp.clip((n - 1) // 2, 0, x.shape[0] - 1)
    return 0.5 * (x[lo] + x[hi])


def _sorted_flux_view(spec: ZSpectrum):
    """(flux, wavelengths, valid) permuted into ascending-flux order.

    The flux ordering does not depend on the candidate redshift — only
    the (wavelength-determined) normalization mask does — so the z scan
    sorts ONCE and each candidate's masked median becomes a cumsum rank
    selection in sorted space (an XLA sort per z was the scan's
    dominant cost: ~170 bitonic passes over the padded spectrum,
    10,000 times)."""
    order = jnp.argsort(spec.flux)
    return spec.flux[order], spec.wavelengths[order], spec.valid[order]


def _masked_median_sorted(flux_sorted, mask_sorted):
    """Exact masked median given ascending-flux-ordered inputs: the
    lo/hi-ranked masked elements selected by cumulative count.  Returns
    +inf for an empty mask (matching ``_masked_median``'s sort-of-inf
    behavior)."""
    n = jnp.sum(mask_sorted)
    csum = jnp.cumsum(mask_sorted.astype(jnp.int32))
    lo_rank = (n - 1) // 2 + 1
    hi_rank = n // 2 + 1

    def pick(rank):
        return jnp.sum(
            jnp.where(mask_sorted & (csum == rank), flux_sorted, 0.0)
        )

    med = 0.5 * (pick(lo_rank) + pick(hi_rank))
    return jnp.where(n > 0, med, jnp.asarray(jnp.inf, flux_sorted.dtype))


def z_log_evidence(
    learned: ZLearnedModel, spec: ZSpectrum, z_qso, params: ZParameters,
    sorted_aux=None, interp_mu_M=None,
):
    """log p(D | z_qso) for one candidate redshift
    (reference: zqso_gp.py:92-212).

    :param sorted_aux: optional ``_sorted_flux_view(spec)`` — lets the
        z-grid scan share one flux sort across all candidates instead
        of sorting per z (identical median values).
    :param interp_mu_M: optional precomputed (mu, M) on the observed
        grid at this z (the shift-scan fast path); default = exact
        interp_uniform from the learned model's linear rest grid.
    """
    wl = spec.wavelengths
    rest = wl / (1.0 + z_qso)

    # observable cut: the part of the spectrum the GP window can cover
    max_obs = jnp.minimum(params.max_lambda * (1.0 + z_qso), jnp.max(jnp.where(spec.valid, wl, -jnp.inf)))
    min_obs = jnp.maximum(params.min_lambda * (1.0 + z_qso), jnp.min(jnp.where(spec.valid, wl, jnp.inf)))
    in_cut = (wl > min_obs) & (wl < max_obs)

    # normalization over the rest-frame window (reference: zqso_gp.py:141-148)
    if sorted_aux is not None:
        flux_s, wl_s, valid_s = sorted_aux
        rest_s = wl_s / (1.0 + z_qso)
        norm_ind_s = (
            (rest_s >= params.normalization_min_lambda)
            & (rest_s <= params.normalization_max_lambda)
            & (wl_s > min_obs)
            & (wl_s < max_obs)
            & valid_s
        )
        median = _masked_median_sorted(flux_s, norm_ind_s)
    else:
        norm_ind = (
            (rest >= params.normalization_min_lambda)
            & (rest <= params.normalization_max_lambda)
            & in_cut
            & spec.valid
        )
        median = _masked_median(spec.flux, norm_ind)
    y = spec.flux / median
    v = spec.noise_variance / (median * median)

    # in-model window
    model_ind = (
        (rest >= params.min_lambda) & (rest <= params.max_lambda) & in_cut & spec.valid
    )

    if interp_mu_M is not None:
        mu, M = interp_mu_M
    else:
        x0 = learned.rest_wavelengths[0]
        dx = learned.rest_wavelengths[1] - learned.rest_wavelengths[0]
        mu = interp_uniform(x0, dx, learned.mu, rest)
        M = interp_uniform(x0, dx, learned.M, rest)

    in_window_ll = log_mvnpdf_low_rank(y, mu, M, v, model_ind)

    # out-of-window pixels: iid Gaussians (reference: zqso_gp.py:196-212)
    bw_ind = (wl < min_obs) & spec.valid
    rw_ind = (wl > max_obs) & spec.valid

    def iid_ll(ind, m, s):
        d = s * s + v
        delta = jnp.where(ind, y - m, 0.0)
        d_inv = jnp.where(ind, 1.0 / d, 0.0)
        log_d = jnp.where(ind, jnp.log(d), 0.0)
        n = jnp.sum(ind)
        return -0.5 * (
            jnp.sum(delta * delta * d_inv) + jnp.sum(log_d) + n * LOG_2PI
        )

    bw_ll = iid_ll(bw_ind, learned.bluewards_mu, learned.bluewards_sigma)
    rw_ll = iid_ll(rw_ind, learned.redwards_mu, learned.redwards_sigma)
    return in_window_ll + bw_ll + rw_ll


def sample_z_qsos(num_samples: int, z_qso_min: float = 2.14, z_qso_max: float = 6.16):
    """The linear redshift grid scanned by the estimator
    (reference: zqso_samples.py:26-29)."""
    return np.linspace(z_qso_min, z_qso_max, num_samples)


# ---------------------------------------------------------------------------
# shift-scan fast path
# ---------------------------------------------------------------------------
# SDSS spectra are uniform in log10(wavelength) (1e-4 dex per pixel), so
# on a log-resampled model grid with spacing pixel_dlog / oversample the
# table index of pixel p at redshift z is  s(z) + oversample * p  — a
# per-z SCALAR shift.  The per-pixel model interpolation then needs no
# gather at all: one dynamic_slice + a strided reshape + a scalar blend.
# (The 10k-z scan would otherwise gather 1.4M elements from a small
# table.)  Resampling the model introduces ~1e-6 relative error
# in mu/M — far below the scan's purpose (|dz| < 0.5 accuracy) — so the
# exact interp_uniform path remains the default for single evidences and
# the conformance suite.


class ZScanTable(NamedTuple):
    """Log-uniformly resampled learned model for the shift scan,
    stored strided: row r, column c holds table entry ``r*oversample +
    c`` with one extra wrap column (``c == oversample`` duplicates the
    next row's first entry), so the two entries pixel p needs —
    ``s0 + oversample*p`` and its +1 neighbor — are one (P, 2)
    dynamic_slice at (s0 // oversample, s0 % oversample)."""

    mu: jnp.ndarray  # (R, oversample + 1)
    M: jnp.ndarray  # (R, oversample + 1, k)


# the shift scan's shared configuration: table layout (oversample) and
# observed-wavelength coverage (wl_bounds) are read by build_scan_table,
# the coverage guard and the slice decode — ONE definition so they can
# never desynchronize
SCAN_OVERSAMPLE = 4
SCAN_WL_BOUNDS = (3.0e3, 1.3e4)


def _flat_resampled_model(
    learned: ZLearnedModel,
    pixel_dlog: float,
    num_pixels: int,
    oversample: int = SCAN_OVERSAMPLE,
    z_min: float = 2.14,
    z_max: float = 6.16,
    wl_bounds: tuple = SCAN_WL_BOUNDS,
):
    """mu/M resampled onto the flat (unstrided) log-uniform rest grid
    shared by the shift scan and the correlation scan: entry t sits at
    rest wavelength ``10**(log_x0 + dlog*t)``, edge-clamped outside the
    model window.

    :return: (grid (T+1,), mu_t (T+1,), M_t (T+1, k), log_x0, dlog, T)
    """
    rest = np.asarray(learned.rest_wavelengths, np.float64)
    dlog = pixel_dlog / oversample
    lo_rest = min(rest[0], wl_bounds[0] / (1.0 + z_max)) * 0.999
    log_x0 = np.log10(lo_rest)
    # highest table entry any slice can touch: the slice starts at the
    # FIRST pixel (<= wl_bounds[1]) and always spans the full padded
    # P-pixel window, which can extend far past the last real pixel
    hi_log_obs = np.log10(wl_bounds[1]) + num_pixels * pixel_dlog
    hi_log_rest = hi_log_obs - np.log10(1.0 + z_min) + 1e-3
    T = int(np.ceil((hi_log_rest - log_x0) / dlog)) + 8 * oversample
    T = -(-T // oversample) * oversample  # whole strided rows
    grid = 10.0 ** (log_x0 + dlog * np.arange(T + 1))
    mu_t = np.interp(grid, rest, np.asarray(learned.mu, np.float64))
    M = np.asarray(learned.M, np.float64)
    M_t = np.stack(
        [np.interp(grid, rest, M[:, j]) for j in range(M.shape[1])], axis=1
    )
    return grid, mu_t, M_t, float(log_x0), float(dlog), T


def build_scan_table(
    learned: ZLearnedModel,
    pixel_dlog: float,
    num_pixels: int,
    oversample: int = SCAN_OVERSAMPLE,
    z_min: float = 2.14,
    z_max: float = 6.16,
    wl_bounds: tuple = SCAN_WL_BOUNDS,
):
    """Resample mu/M onto a log-uniform rest grid covering every
    (pixel, z) combination of the scan, edge-clamped outside the model
    window (those pixels are mask-excluded from the likelihood).

    :param num_pixels: the PADDED pixel count P — each z slices P rows
        starting at its shift, so the table must extend
        ``num_pixels * pixel_dlog`` past the bluest first-pixel
        position or ``dynamic_slice`` would silently clamp the start
        and shift the model for every pixel.
    :return: (table, log_x0, dlog)
    """
    grid, mu_t, M_t, log_x0, dlog, T = _flat_resampled_model(
        learned, pixel_dlog, num_pixels, oversample, z_min, z_max, wl_bounds
    )

    def stride_view(flat):
        # (T+1[, k]) -> (R, oversample + 1[, k]) with the wrap column
        R = T // oversample
        main = flat[:T].reshape((R, oversample) + flat.shape[1:])
        wrap = flat[oversample::oversample][:R][:, None]
        return np.concatenate([main, wrap], axis=1)

    return ZScanTable(
        mu=jnp.asarray(stride_view(mu_t)), M=jnp.asarray(stride_view(M_t))
    ), float(log_x0), float(dlog)


def detect_pixel_dlog(wavelengths, max_drift: float = 0.02):
    """The per-pixel log10-wavelength step if the grid is log-uniform
    (trailing padded pixels — zero diffs — are ignored), else None.

    The step is fit from the endpoints and validated against the
    CUMULATIVE deviation ``max |log(wl_p) - (log(wl_0) + p d)|`` — a
    per-diff jitter bound would accept quasi-uniform grids (e.g. a
    linear grid over a narrow band) whose accumulated drift misplaces
    the model by many pixels.  The returned step is quantized to 1e-9
    dex so float jitter between spectra of the same survey cannot
    produce distinct values (each distinct value is a scan-table build
    plus a jit recompile).
    """
    logs = np.log10(np.asarray(wavelengths, np.float64))
    diffs = np.diff(logs)
    real = diffs > 0
    if real.sum() < 2:
        return None
    # padding must be a pure tail
    last_real = np.nonzero(real)[0][-1]
    if not real[: last_real + 1].all():
        return None
    d = (logs[last_real + 1] - logs[0]) / (last_real + 1)
    d = round(float(d), 9)
    if d <= 0:
        return None
    p = np.arange(last_real + 2)
    drift = np.max(np.abs(logs[: last_real + 2] - (logs[0] + p * d)))
    if drift > max_drift * d:
        return None
    return d


@partial(
    jax.jit,
    static_argnames=("params", "chunk_size", "log_x0", "dlog", "oversample"),
)
def z_log_evidences_shift(
    learned: ZLearnedModel,
    table: ZScanTable,
    spec: ZSpectrum,
    z_grid: jnp.ndarray,
    params: ZParameters,
    log_x0: float,
    dlog: float,
    oversample: int,
    chunk_size: int = 250,
):
    """log p(D | z) over the grid via the shift scan (see above)."""
    Z = z_grid.shape[0]
    P = spec.wavelengths.shape[0]
    n_chunks = -(-Z // chunk_size)
    pad = n_chunks * chunk_size - Z
    z_padded = jnp.concatenate([z_grid, jnp.full((pad,), z_grid[-1], z_grid.dtype)])
    chunks = z_padded.reshape(n_chunks, chunk_size)

    sorted_aux = _sorted_flux_view(spec)
    log_wl0 = jnp.log10(spec.wavelengths[0])
    k = table.M.shape[-1]

    def one(z):
        s_real = (log_wl0 - jnp.log10(1.0 + z) - log_x0) / dlog
        s0 = jnp.floor(s_real).astype(jnp.int32)
        frac = (s_real - s0).astype(table.mu.dtype)
        w = s0 // oversample
        c = s0 - w * oversample
        zero = jnp.zeros((), s0.dtype)
        r = jax.lax.dynamic_slice(table.mu, (w, c), (P, 2))  # (P, 2)
        mu = (1.0 - frac) * r[:, 0] + frac * r[:, 1]
        rM = jax.lax.dynamic_slice(table.M, (w, c, zero), (P, 2, k))
        M = (1.0 - frac) * rM[:, 0, :] + frac * rM[:, 1, :]
        return z_log_evidence(
            learned, spec, z, params, sorted_aux, interp_mu_M=(mu, M)
        )

    def one_chunk(zs):
        return jax.vmap(one)(zs)

    lls = jax.lax.map(one_chunk, chunks).reshape(-1)
    return lls[:Z]


@partial(jax.jit, static_argnames=("params", "chunk_size"))
def z_log_evidences(
    learned: ZLearnedModel,
    spec: ZSpectrum,
    z_grid: jnp.ndarray,
    params: ZParameters,
    chunk_size: int = 250,
):
    """log p(D | z) over the whole grid, chunked vmap to bound memory."""
    Z = z_grid.shape[0]
    n_chunks = -(-Z // chunk_size)
    pad = n_chunks * chunk_size - Z
    z_padded = jnp.concatenate([z_grid, jnp.full((pad,), z_grid[-1], z_grid.dtype)])
    chunks = z_padded.reshape(n_chunks, chunk_size)

    sorted_aux = _sorted_flux_view(spec)  # one sort for the whole grid

    def one_chunk(zs):
        return jax.vmap(
            lambda z: z_log_evidence(learned, spec, z, params, sorted_aux)
        )(zs)

    lls = jax.lax.map(one_chunk, chunks).reshape(-1)
    return lls[:Z]


# scan tables memoized per (learned model identity, pixel grid step)
_SCAN_TABLE_CACHE: dict = {}


def _scan_table_for(learned, pixel_dlog, num_pixels, z_qso_min, z_qso_max):
    key = (id(learned), pixel_dlog, num_pixels, z_qso_min, z_qso_max)
    return memo_by_identity(
        _SCAN_TABLE_CACHE,
        key,
        learned,
        lambda: build_scan_table(
            learned, pixel_dlog, num_pixels, z_min=z_qso_min, z_max=z_qso_max
        ),
    )


def _dispatch_scan(
    learned: ZLearnedModel,
    spec: ZSpectrum,
    params: ZParameters,
    z_qso_min: float,
    z_qso_max: float,
    method: str,
):
    """Enqueue one spectrum's z scan; returns (z_grid, device lls)."""
    if method not in ("auto", "corr", "shift", "exact"):
        raise ValueError(
            f"unknown method {method!r}: expected 'auto', 'corr', 'shift' "
            "or 'exact'"
        )
    z_grid = jnp.asarray(sample_z_qsos(params.num_zqso_samples, z_qso_min, z_qso_max))
    wl_np = np.asarray(spec.wavelengths)
    pixel_dlog = detect_pixel_dlog(wl_np) if method != "exact" else None
    # the shared table covers observed wavelengths within SCAN_WL_BOUNDS;
    # anything outside falls back to the exact scan
    if pixel_dlog is not None and (
        wl_np[0] < SCAN_WL_BOUNDS[0] or wl_np[-1] > SCAN_WL_BOUNDS[1]
    ):
        pixel_dlog = None
    if method in ("shift", "corr") and pixel_dlog is None:
        raise ValueError(
            f"the {method} scan requires a log-uniform pixel grid within "
            f"{SCAN_WL_BOUNDS[0]:.0f}-{SCAN_WL_BOUNDS[1]:.0f} A"
        )
    if pixel_dlog is not None and method != "shift":
        # default fast path: the all-shifts correlation scan
        # (models/zqso_corr.py) — no per-z table reads at all
        from .zqso_corr import corr_table_for, z_log_evidences_corr

        ct = corr_table_for(
            learned, pixel_dlog, int(wl_np.shape[0]), params,
            z_qso_min, z_qso_max,
        )
        lls = z_log_evidences_corr(
            learned, ct.stream_fft, spec, z_grid, params,
            ct.log_x0, ct.dlog, ct.oversample, ct.k, ct.nfft,
        )
    elif pixel_dlog is not None:
        table, log_x0, dlog = _scan_table_for(
            learned, pixel_dlog, wl_np.shape[0], z_qso_min, z_qso_max
        )
        lls = z_log_evidences_shift(
            learned, table, spec, z_grid, params, log_x0, dlog,
            SCAN_OVERSAMPLE,
        )
    else:
        lls = z_log_evidences(learned, spec, z_grid, params)
    return z_grid, lls


def inference_z_qso(
    learned: ZLearnedModel,
    spec: ZSpectrum,
    params: ZParameters,
    z_qso_min: float = 2.14,
    z_qso_max: float = 6.16,
    method: str = "auto",
):
    """MAP redshift over the sample grid (reference: zqso_gp.py:214-250).

    :param method: "shift" (log-resampled-model fast scan; requires a
        log-uniform pixel grid), "exact" (per-z interp_uniform), or
        "auto" — shift when the grid allows it, exact otherwise.
    :return: (z_map, sample_log_likelihoods, z_grid)
    """
    z_grid, lls = _dispatch_scan(
        learned, spec, params, z_qso_min, z_qso_max, method
    )
    lls_np = np.asarray(lls)
    if not np.isfinite(lls_np).any():
        # same contract as inference_z_qso_many: an all-NaN scan is
        # NaN, not whatever grid endpoint jnp.nanargmax falls back to
        return float("nan"), lls_np, np.asarray(z_grid)
    idx = np.nanargmax(lls_np)
    return float(np.asarray(z_grid)[idx]), lls_np, np.asarray(z_grid)


def inference_z_qso_many(
    learned: ZLearnedModel,
    specs,
    params: ZParameters,
    z_qso_min: float = 2.14,
    z_qso_max: float = 6.16,
    method: str = "auto",
    keep_lls: bool = False,
    max_in_flight: int = 32,
):
    """Pipelined multi-spectrum redshift estimation: scans are enqueued
    up to ``max_in_flight`` ahead of the readback, so the per-spectrum
    device->host transfers overlap the device compute while device
    memory stays bounded.

    ``specs`` may be any iterable (e.g. a prefetching generator —
    spectra are pulled as scans dispatch, so file reads also overlap).

    :param keep_lls: include each spectrum's full (num_zqso_samples,)
        log-likelihood array in the results (large; off by default so
        survey runs don't accumulate them in host memory).
    :return: ([(z_map, lls or None), ...], z_grid).  ``z_map`` is NaN
        for a spectrum whose scan produced no finite evidence.
    """
    import collections

    z_grid = None
    in_flight: collections.deque = collections.deque()
    results = []

    def drain_one():
        lls_np = np.asarray(in_flight.popleft())
        finite = np.isfinite(lls_np)
        z_map = (
            float(z_np[np.nanargmax(np.where(finite, lls_np, -np.inf))])
            if finite.any()
            else float("nan")
        )
        results.append((z_map, lls_np if keep_lls else None))

    z_np = None
    for spec in specs:
        z_grid, lls = _dispatch_scan(
            learned, spec, params, z_qso_min, z_qso_max, method
        )
        if z_np is None:
            z_np = np.asarray(z_grid)
        try:
            lls.copy_to_host_async()
        except AttributeError:
            pass
        in_flight.append(lls)
        if len(in_flight) > max_in_flight:
            drain_one()
    while in_flight:
        drain_one()
    return results, z_np
