"""zQSO redshift scan as strided cross-correlations (FFT).

The shift scan (models/zqso.py ``z_log_evidences_shift``) reads, per
candidate redshift, a (P, 2, k+1) window of the resampled model table —
~2.7 GB of dynamic-slice traffic per spectrum.  This module removes the per-z table reads entirely
by observing that on a log-uniform pixel grid EVERY per-z reduction of
the low-rank evidence (reference: zqso_gp.py:92-212, log_mvnpdf_low_rank
zqso_gp.py:252-284) is a strided cross-correlation

    C[s] = sum_p A[p] * S[s + O*p]

between a z-independent spectrum-side weight stream ``A`` (e.g.
valid/noise, valid*flux/noise) and a z-independent table-side model
stream ``S`` (e.g. M_i*M_j, mu*M_i), evaluated at the per-z integer
shift ``s0(z)``.  All shifts are computed at once per (weight, stream)
pair by FFT over the ``O`` polyphase components, after which each z
needs one row of the correlation matrix plus scalar algebra:

* capacitance  B(z) = I + med^2 * sum_f w_f(frac) C[iv x MiMj-family]
* projection   u(z), data quad, log dets, pixel counts — same shape
* the k x k solve runs as ``ops/logmvn.batched_quad_logdet`` over all
  z at once (the batched-Cholesky-unroll kernel of the DLA pipeline)

The fractional part of the shift (the linear blend between adjacent
table rows) is folded into the STREAMS: for every product stream the
``_pp`` variant carries both factors at t+1 and the ``_pm`` variant the
symmetrized cross term, so a single correlation row per z covers the
exact (1-f)^2 / f^2 / f(1-f) blend — no second gather.

Differences vs the shift path (both validated by tests):
* the in-model mask comes from the resampled grid's rest window
  (``val`` stream) instead of per-pixel exact rest comparisons — they
  can disagree on <=1 edge pixel per window edge per z;
* the strict observable cut against the spectrum's own first/last
  valid wavelength is applied statically in the weights;
* correlations accumulate in f32 FFTs (error ~1e-5 relative — the
  scan's margins are orders of magnitude larger).

The per-z O(P) parts that cannot be correlations (the masked-median
normalization — the median is not a linear reduction — and the
blue/redwards iid tails whose denominators mix the per-z normalization
with per-pixel noise) stay as chunked elementwise passes, identical to
the shift path's.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.logmvn import LOG_2PI, batched_quad_logdet
from ..params import ZParameters
from ..utils.memo import memo_by_identity
from .zqso import (
    SCAN_OVERSAMPLE,
    SCAN_WL_BOUNDS,
    ZLearnedModel,
    ZSpectrum,
    _flat_resampled_model,
    _masked_median_sorted,
    _sorted_flux_view,
    sample_z_qsos,
)


class ZCorrTable(NamedTuple):
    """FFTs of the polyphase model streams + assembly metadata."""

    stream_fft: jnp.ndarray  # (ns, O, F) complex64 — rfft of streams
    log_x0: float
    dlog: float
    oversample: int
    k: int
    nfft: int


def _stream_layout(k: int):
    """Column indices of each stream family in the stream stack.

    Order: val, mu, mu2, mu_pp, mumu_pm, mu2_pp, Mi (k), Mi_pp (k),
    muMi (k), muMi_pp (k), muMi_pm (k), then the k(k+1)/2 upper pairs
    of MiMj, MiMj_pp, MiMj_pm.
    """
    idx = {}
    pos = 0
    for name in ("val", "mu", "mu2", "mu_pp", "mumu_pm", "mu2_pp"):
        idx[name] = pos
        pos += 1
    for name in ("Mi", "Mi_pp", "muMi", "muMi_pp", "muMi_pm"):
        idx[name] = pos
        pos += k
    n_pairs = k * (k + 1) // 2
    for name in ("MiMj", "MiMj_pp", "MiMj_pm"):
        idx[name] = pos
        pos += n_pairs
    return idx, pos


def build_corr_table(
    learned: ZLearnedModel,
    pixel_dlog: float,
    num_pixels: int,
    params: ZParameters,
    oversample: int = SCAN_OVERSAMPLE,
    z_min: float = 2.14,
    z_max: float = 6.16,
    wl_bounds: tuple = SCAN_WL_BOUNDS,
) -> ZCorrTable:
    """Model streams on the flat log-uniform grid, destrided into
    ``oversample`` polyphase components and FFT'd once (cacheable per
    learned model / pixel grid — shared by every spectrum)."""
    grid, mu_t, M_t, log_x0, dlog, T = _flat_resampled_model(
        learned, pixel_dlog, num_pixels, oversample, z_min, z_max, wl_bounds
    )
    k = M_t.shape[1]
    idx, ns = _stream_layout(k)

    # in-model mask on the grid (the rest window; reference:
    # zqso_gp.py:150-156 model_ind)
    val = (
        (grid >= params.min_lambda) & (grid <= params.max_lambda)
    ).astype(np.float64)

    # flat streams, t axis length T+1; "+1"-offset factors use t+1
    mu1 = np.empty_like(mu_t)
    mu1[:-1], mu1[-1] = mu_t[1:], mu_t[-1]
    M1 = np.empty_like(M_t)
    M1[:-1], M1[-1] = M_t[1:], M_t[-1]

    S = np.zeros((ns, T + 1))
    S[idx["val"]] = val
    S[idx["mu"]] = val * mu_t
    S[idx["mu2"]] = val * mu_t * mu_t
    S[idx["mu_pp"]] = val * mu1
    S[idx["mumu_pm"]] = val * mu_t * mu1
    S[idx["mu2_pp"]] = val * mu1 * mu1
    for i in range(k):
        S[idx["Mi"] + i] = val * M_t[:, i]
        S[idx["Mi_pp"] + i] = val * M1[:, i]
        S[idx["muMi"] + i] = val * mu_t * M_t[:, i]
        S[idx["muMi_pp"] + i] = val * mu1 * M1[:, i]
        S[idx["muMi_pm"] + i] = val * (
            mu_t * M1[:, i] + mu1 * M_t[:, i]
        )
    p = 0
    for i in range(k):
        for j in range(i, k):
            S[idx["MiMj"] + p] = val * M_t[:, i] * M_t[:, j]
            S[idx["MiMj_pp"] + p] = val * M1[:, i] * M1[:, j]
            S[idx["MiMj_pm"] + p] = val * (
                M_t[:, i] * M1[:, j] + M1[:, i] * M_t[:, j]
            )
            p += 1

    # destride: S_c[r] = S[O*r + c]  (polyphase components)
    O = oversample
    R = (T + 1) // O
    S_poly = np.stack(
        [S[:, c : c + O * R : O] for c in range(O)], axis=1
    )  # (ns, O, R)

    nfft = 1 << int(np.ceil(np.log2(R + num_pixels + 2)))
    # FFT on device: ship the real streams and keep the rfft result
    # device-resident.
    stream_fft = jax.jit(
        lambda s: jnp.fft.rfft(s, n=nfft, axis=-1), static_argnums=()
    )(jnp.asarray(S_poly.astype(np.float32)))
    return ZCorrTable(
        stream_fft=stream_fft,
        log_x0=log_x0,
        dlog=dlog,
        oversample=O,
        k=k,
        nfft=nfft,
    )


def _tri_to_full(cols, k):
    """(Z, k(k+1)/2) upper-pair columns -> (Z, k, k) symmetric."""
    Z = cols.shape[0]
    out = jnp.zeros((Z, k, k), cols.dtype)
    p = 0
    for i in range(k):
        for j in range(i, k):
            out = out.at[:, i, j].set(cols[:, p])
            if i != j:
                out = out.at[:, j, i].set(cols[:, p])
            p += 1
    return out


@partial(
    jax.jit,
    static_argnames=("params", "oversample", "k", "nfft", "chunk_size"),
)
def z_log_evidences_corr(
    learned: ZLearnedModel,
    stream_fft: jnp.ndarray,
    spec: ZSpectrum,
    z_grid: jnp.ndarray,
    params: ZParameters,
    log_x0: float,
    dlog: float,
    oversample: int,
    k: int,
    nfft: int,
    chunk_size: int = 500,
):
    """log p(D | z) over the grid via the correlation scan."""
    O = oversample
    wl = spec.wavelengths
    f32 = jnp.float32

    # --- spectrum-side weights (z-independent) ---------------------
    valid = spec.valid
    wl_lo = jnp.min(jnp.where(valid, wl, jnp.inf))
    wl_hi = jnp.max(jnp.where(valid, wl, -jnp.inf))
    # static part of the observable cut (reference: zqso_gp.py:135-139)
    sv = (valid & (wl > wl_lo) & (wl < wl_hi)).astype(f32)
    noise = jnp.asarray(spec.noise_variance, f32)
    flux = jnp.asarray(spec.flux, f32)
    inv_n = jnp.where(sv > 0, 1.0 / noise, 0.0)
    weights = jnp.stack(
        [
            sv * inv_n,  # iv
            sv * inv_n * flux,  # ivf
            sv * inv_n * flux * flux,  # ivf2
            sv * jnp.where(sv > 0, jnp.log(noise), 0.0),  # lgn
            sv,  # one
        ]
    )  # (5, P)

    w_fft = jnp.fft.rfft(weights, n=nfft, axis=-1)  # (5, F)

    # --- all-shift correlations ------------------------------------
    idx, ns = _stream_layout(k)
    # pair (weight index, stream index) for every correlation row
    pw, ps = [], []

    def pair(w, s, count=1):
        base = len(pw)
        for t in range(count):
            pw.append(w)
            ps.append(s + t)
        return base

    IV, IVF, IVF2, LGN, ONE = range(5)
    c_mu2 = pair(IV, idx["mu2"])
    c_mu2pp = pair(IV, idx["mu2_pp"])
    c_mumupm = pair(IV, idx["mumu_pm"])
    c_muMi = pair(IV, idx["muMi"], k)
    c_muMipp = pair(IV, idx["muMi_pp"], k)
    c_muMipm = pair(IV, idx["muMi_pm"], k)
    c_MiMj = pair(IV, idx["MiMj"], k * (k + 1) // 2)
    c_MiMjpp = pair(IV, idx["MiMj_pp"], k * (k + 1) // 2)
    c_MiMjpm = pair(IV, idx["MiMj_pm"], k * (k + 1) // 2)
    c_fmu = pair(IVF, idx["mu"])
    c_fmupp = pair(IVF, idx["mu_pp"])
    c_fMi = pair(IVF, idx["Mi"], k)
    c_fMipp = pair(IVF, idx["Mi_pp"], k)
    c_f2val = pair(IVF2, idx["val"])
    c_lgn = pair(LGN, idx["val"])
    c_n = pair(ONE, idx["val"])
    pw = jnp.asarray(pw)
    ps_arr = np.asarray(ps)
    nc = len(ps)

    # C_c[r] = sum_p A[p] S_c[r+p]  ==  irfft(conj(fft A) * fft S_c)
    prod = jnp.conj(w_fft)[pw][:, None, :] * stream_fft[ps_arr]  # (nc,O,F)
    corr = jnp.fft.irfft(prod, n=nfft, axis=-1)  # (nc, O, nfft)
    # interleave phases back to the flat shift axis: flat s = O*r + c
    corr_flat = corr.transpose(2, 1, 0).reshape(nfft * O, nc)  # (L, nc)

    # --- per-z shift + one correlation row per z -------------------
    log_wl0 = jnp.log10(wl[0])
    s_real = (log_wl0 - jnp.log10(1.0 + z_grid) - log_x0) / dlog
    s0 = jnp.floor(s_real).astype(jnp.int32)
    f = (s_real - s0).astype(f32)
    rows = jnp.take(corr_flat, s0, axis=0)  # (Z, nc) row gather

    w00 = ((1.0 - f) * (1.0 - f))[:, None]
    w11 = (f * f)[:, None]
    w01 = (f * (1.0 - f))[:, None]

    def blend2(base, basepp, basepm, count):
        return (
            w00 * jax.lax.dynamic_slice_in_dim(rows, base, count, 1)
            + w11 * jax.lax.dynamic_slice_in_dim(rows, basepp, count, 1)
            + w01 * jax.lax.dynamic_slice_in_dim(rows, basepm, count, 1)
        )

    def blend1(base, basepp, count):
        return (1.0 - f)[:, None] * jax.lax.dynamic_slice_in_dim(
            rows, base, count, 1
        ) + f[:, None] * jax.lax.dynamic_slice_in_dim(rows, basepp, count, 1)

    n_in = rows[:, c_n]  # (Z,) in-window pixel count
    sum_lgn = rows[:, c_lgn]
    sum_f2 = rows[:, c_f2val]
    mu2_b = blend2(c_mu2, c_mu2pp, c_mumupm, 1)[:, 0]
    fmu_b = blend1(c_fmu, c_fmupp, 1)[:, 0]
    muMi_b = blend2(c_muMi, c_muMipp, c_muMipm, k)  # (Z, k)
    fMi_b = blend1(c_fMi, c_fMipp, k)  # (Z, k)
    MiMj_b = blend2(c_MiMj, c_MiMjpp, c_MiMjpm, k * (k + 1) // 2)
    # NOTE: mumu_pm stream stores mu[t]*mu[t+1] once; the (1-f)f cross
    # term needs it twice
    mu2_b = mu2_b + (w01[:, 0] * rows[:, c_mumupm])

    # --- per-z normalization + iid tails (chunked elementwise) -----
    flux_s, wl_s, valid_s = _sorted_flux_view(spec)
    min_obs = jnp.maximum(params.min_lambda * (1.0 + z_grid), wl_lo)
    max_obs = jnp.minimum(params.max_lambda * (1.0 + z_grid), wl_hi)

    Z = z_grid.shape[0]
    n_chunks = -(-Z // chunk_size)
    pad = n_chunks * chunk_size - Z
    zpad = lambda x: jnp.concatenate(
        [x, jnp.broadcast_to(x[-1:], (pad,) + x.shape[1:])]
    )
    lo_c = zpad(min_obs).reshape(n_chunks, chunk_size)
    hi_c = zpad(max_obs).reshape(n_chunks, chunk_size)
    z_c = zpad(jnp.asarray(z_grid)).reshape(n_chunks, chunk_size)

    def one_chunk(args):
        lo, hi, z = args  # (C,)
        rest_s = wl_s[None, :] / (1.0 + z)[:, None]
        norm = (
            (rest_s >= params.normalization_min_lambda)
            & (rest_s <= params.normalization_max_lambda)
            & (wl_s[None, :] > lo[:, None])
            & (wl_s[None, :] < hi[:, None])
            & valid_s[None, :]
        )
        med = jax.vmap(_masked_median_sorted, in_axes=(None, 0))(
            flux_s, norm
        )  # (C,)

        def iid(ind, m, s):
            # (C, P) masked iid loglik (reference: zqso_gp.py:196-212)
            d = s * s + spec.noise_variance[None, :] / (med * med)[:, None]
            y = spec.flux[None, :] / med[:, None]
            delta = jnp.where(ind, y - m, 0.0)
            d_inv = jnp.where(ind, 1.0 / d, 0.0)
            log_d = jnp.where(ind, jnp.log(d), 0.0)
            n = jnp.sum(ind, axis=1)
            return -0.5 * (
                jnp.sum(delta * delta * d_inv, axis=1)
                + jnp.sum(log_d, axis=1)
                + n * LOG_2PI
            )

        bw = (wl[None, :] < lo[:, None]) & valid[None, :]
        rw = (wl[None, :] > hi[:, None]) & valid[None, :]
        bw_ll = iid(bw, learned.bluewards_mu, learned.bluewards_sigma)
        rw_ll = iid(rw, learned.redwards_mu, learned.redwards_sigma)
        return med, bw_ll + rw_ll

    med, iid_ll = jax.lax.map(one_chunk, (lo_c, hi_c, z_c))
    med = med.reshape(-1)[:Z].astype(f32)
    iid_ll = iid_ll.reshape(-1)[:Z]

    # --- assemble the in-window evidence ---------------------------
    # a fully-masked SPECTRUM has med = +inf with every correlation
    # term 0; neutralize med so the 0 * inf products cannot poison the
    # flat-zero scan the shift path produces in that case.  A per-z
    # empty NORMALIZATION WINDOW on an otherwise-valid spectrum is
    # different: the normalized likelihood is undefined there, so the
    # candidate must come back NaN (excluded by the caller's
    # nanargmax) exactly like the exact/shift paths — not a finite
    # garbage value competing in the argmax.
    med_bad = ~jnp.isfinite(med)
    med = jnp.where(med_bad, 1.0, med)
    med2 = med * med
    B = jnp.eye(k, dtype=f32)[None] + med2[:, None, None] * _tri_to_full(
        MiMj_b, k
    )
    u = med[:, None] * fMi_b - med2[:, None] * muMi_b
    quad_corr, logdetB = batched_quad_logdet(B, u)
    quad0 = sum_f2 - 2.0 * med * fmu_b + med2 * mu2_b
    logdet0 = sum_lgn - 2.0 * n_in * jnp.log(med)
    in_ll = -0.5 * (
        quad0 - quad_corr + logdet0 + logdetB + n_in * LOG_2PI
    )
    in_ll = jnp.where(med_bad & jnp.any(valid), jnp.nan, in_ll)
    return in_ll + iid_ll


# table FFTs memoized per (learned model identity, pixel grid step)
_CORR_TABLE_CACHE: dict = {}


def corr_table_for(
    learned, pixel_dlog, num_pixels, params, z_qso_min, z_qso_max
):
    key = (
        id(learned), pixel_dlog, num_pixels, params, z_qso_min, z_qso_max,
    )
    return memo_by_identity(
        _CORR_TABLE_CACHE,
        key,
        learned,
        lambda: build_corr_table(
            learned, pixel_dlog, num_pixels, params,
            z_min=z_qso_min, z_max=z_qso_max,
        ),
    )


def z_scan_corr(
    learned: ZLearnedModel,
    spec: ZSpectrum,
    params: ZParameters,
    pixel_dlog: float,
    z_qso_min: float = 2.14,
    z_qso_max: float = 6.16,
):
    """Convenience wrapper: build/cache the corr table and scan one
    spectrum.  Returns (z_grid, lls device array)."""
    table = corr_table_for(
        learned, pixel_dlog, int(spec.wavelengths.shape[0]), params,
        z_qso_min, z_qso_max,
    )
    z_grid = jnp.asarray(
        sample_z_qsos(params.num_zqso_samples, z_qso_min, z_qso_max)
    )
    lls = z_log_evidences_corr(
        learned, table.stream_fft, spec, z_grid, params,
        table.log_x0, table.dlog, table.oversample, table.k, table.nfft,
    )
    return z_grid, lls
