"""Strong-Lya-absorber (LLS) search.

Rebuild of the reference's self-contained LLS finder
(reference: examples/gp_find_lls.py:52-1075): the same GP + QMC
machinery as the DLA pipeline but with

* the Lyman-limit-break absorption profile (ops/voigt.py
  ``voigt_absorption_lls``),
* a data-driven column-density prior on logNHI in [17.2, 23]: the
  Garnett (2017) quadratic-fit density above 20.03 with a flat
  extension below it (reference: gp_find_lls.py:325-351 LyaSamples
  ``_build_pdf``), sampled by analytic inverse-CDF at Halton points
  (the reference wraps externally generated samples of the same
  density),
* the catalog-driven model priors P(k absorbers | z_qso) of the DLA
  pipeline (reference: gp_find_lls.py:757-767 save_processed_file),
* optionally the BOSS mean-flux parameters tau_0 = 0.00554,
  beta = 3.182 (reference: gp_find_lls.py:404-417).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
from functools import partial
import numpy as np
from scipy.special import logsumexp

from ..data.samples import (
    _fit_pdf,
    _gaussian_fit_integral,
    _invert_cdf,
    halton_sequence,
)
from ..data.spectrum import Spectrum
from ..params import Parameters
from .evidence import null_log_evidence, qmc_log_evidences
from .learned import LearnedModel, build_spectrum_model
from .selection import log_priors_k_dlas

# BOSS DR12 mean-flux measurement used by the LLS search
# (reference: gp_find_lls.py:404-417, 957-966)
BOSS_TAU_0 = 0.00554
BOSS_BETA = 3.182

# below this column density the Garnett quadratic fit is extended flat
# (reference: gp_find_lls.py:333-340)
LYA_FLAT_BELOW = 20.03


class LyaSamples(NamedTuple):
    """QMC samples for strong Lya absorbers: uniform z offsets and
    logNHI from the chosen prior (reference: gp_find_lls.py:227-351)."""

    offset_samples: np.ndarray
    log_nhi_samples: np.ndarray
    nhi_samples: np.ndarray


def _lya_unnormalized_integral(lo, hi):
    """integral of the flat-below-20.03 Garnett density over [lo, hi];
    vectorized over ``hi`` (``lo`` is a scalar)."""
    lo = np.float64(lo)
    hi = np.asarray(hi, np.float64)
    flat = _fit_pdf(LYA_FLAT_BELOW) * np.clip(
        np.minimum(hi, LYA_FLAT_BELOW) - lo, 0.0, None
    )
    gauss = np.where(
        hi > LYA_FLAT_BELOW,
        _gaussian_fit_integral(
            max(lo, LYA_FLAT_BELOW), np.maximum(hi, LYA_FLAT_BELOW)
        ),
        0.0,
    )
    return flat + gauss


def lya_log_nhi_pdf(
    log_nhi, min_log_nhi: float = 17.2, max_log_nhi: float = 23.0
):
    """Normalized logNHI prior density of the LLS search: the Garnett
    (2017) fit with a flat low-column extension, normalized on
    [min_log_nhi, max_log_nhi] (reference: gp_find_lls.py:325-351)."""
    log_nhi = np.asarray(log_nhi, np.float64)
    Z = _lya_unnormalized_integral(min_log_nhi, max_log_nhi)
    raw = np.where(
        log_nhi < LYA_FLAT_BELOW, _fit_pdf(LYA_FLAT_BELOW), _fit_pdf(log_nhi)
    )
    in_range = (log_nhi >= min_log_nhi) & (log_nhi <= max_log_nhi)
    return np.where(in_range, raw / Z, 0.0)


def generate_lya_samples(
    num_samples: int = 10000,
    min_log_nhi: float = 17.2,
    max_log_nhi: float = 23.0,
    prior: str = "garnett",
) -> LyaSamples:
    """QMC samples of (z offset, logNHI) for the LLS search.

    ``prior="garnett"`` (default) inverse-CDF samples the data-driven
    density of ``lya_log_nhi_pdf`` — the prior the reference's shipped
    sample file encodes; ``prior="uniform"`` keeps a flat logNHI prior.
    """
    seq = halton_sequence(num_samples, 2)
    if prior == "uniform":
        log_nhi = min_log_nhi + (max_log_nhi - min_log_nhi) * seq[:, 1]
    elif prior == "garnett":
        Z = _lya_unnormalized_integral(min_log_nhi, max_log_nhi)
        cdf = lambda x: _lya_unnormalized_integral(min_log_nhi, x) / Z
        log_nhi = _invert_cdf(seq[:, 1], cdf, min_log_nhi, max_log_nhi)
    else:
        raise ValueError(f"unknown prior {prior!r}")
    return LyaSamples(
        offset_samples=seq[:, 0],
        log_nhi_samples=log_nhi,
        nhi_samples=10.0**log_nhi,
    )


def with_boss_meanflux(learned: LearnedModel) -> LearnedModel:
    """Swap the Kim mean-flux parameters for the BOSS measurement."""
    return learned._replace(
        prev_tau_0=np.float64(BOSS_TAU_0), prev_beta=np.float64(BOSS_BETA)
    )


def lls_log_evidences(
    learned: LearnedModel,
    spec: Spectrum,
    samples: LyaSamples,
    key: jax.Array,
    max_lya: int,
    params: Parameters,
    base_inds_override=None,
):
    """(null evidence, QMC result for 1..max_lya absorbers) for one
    spectrum, using the LLS-break profile
    (reference: gp_find_lls.py:825-1075)."""
    import jax.numpy as jnp

    model = build_spectrum_model(learned, spec, params)
    result = qmc_log_evidences(
        model,
        jnp.asarray(samples.offset_samples),
        jnp.asarray(samples.log_nhi_samples),
        jnp.asarray(samples.nhi_samples),
        key,
        max_lya,
        params,
        profile="lls",
        base_inds_override=base_inds_override,
    )
    return null_log_evidence(model), result


def lls_model_posteriors(
    log_evidence_null: float,
    log_evidences_lls: np.ndarray,
    num_dlas: int | None = None,
    num_quasars: int | None = None,
    p_lls: float = 0.5,
):
    """Posterior over {no absorber, 1..k absorbers}.

    With catalog counts (``num_dlas``/``num_quasars`` from
    ``PriorCatalog.less_ind``) the absorber priors are the DLA
    pipeline's data-driven P(k | z_qso) = (M/N)^k differences and the
    null prior is 1 minus their total — exactly the reference's
    combination (reference: gp_find_lls.py:757-767 save_processed_file,
    dla_gp.py:398-426).  Without counts, falls back to splitting
    ``p_lls`` flat over k (an uninformative prior).
    """
    k = np.size(log_evidences_lls)
    if num_dlas is not None and num_quasars is not None:
        log_priors_abs = log_priors_k_dlas(num_dlas, num_quasars, k)
        log_prior_null = np.log1p(-np.exp(logsumexp(log_priors_abs)))
        log_priors = np.concatenate([[log_prior_null], log_priors_abs])
    else:
        log_priors = np.log(
            np.concatenate([[1.0 - p_lls], np.full(k, p_lls / k)])
        )
    log_post = (
        np.concatenate([[log_evidence_null], np.ravel(log_evidences_lls)])
        + log_priors
    )
    m = np.nanmax(log_post)
    with np.errstate(invalid="ignore"):
        post = np.exp(log_post - m)
    post = np.nan_to_num(post)
    post /= post.sum()
    return post


class FumagalliTable(NamedTuple):
    """The Fumagalli+ 2020 LLS truth table (staa2388 supplemental data)
    (reference: tests/test_selection_fumagalli.py:4-43)."""

    quasar_name: np.ndarray
    right_ascension_deg: np.ndarray
    declination_deg: np.ndarray
    redshift: np.ndarray
    SN_1150A: np.ndarray
    science_primary: np.ndarray
    in_training_set: np.ndarray
    classification_outcome: np.ndarray
    LLS_redshift: np.ndarray


def load_fumagalli_table(
    filepath: str, skiprows: int = 15
) -> FumagalliTable:
    """Parse the whitespace-separated Fumagalli supplemental table
    (reference: tests/test_selection_fumagalli.py:22-43; pandas-free)."""
    names, ras, decs, zs, sns = [], [], [], [], []
    prim, train, outcome, z_lls = [], [], [], []
    with open(filepath) as f:
        for i, line in enumerate(f):
            if i < skiprows:
                continue
            parts = line.split()
            if len(parts) < 9:
                continue
            names.append(parts[0])
            ras.append(float(parts[1]))
            decs.append(float(parts[2]))
            zs.append(float(parts[3]))
            sns.append(float(parts[4]))
            prim.append(int(float(parts[5])))
            train.append(int(float(parts[6])))
            outcome.append(int(float(parts[7])))
            z_lls.append(float(parts[8]))
    return FumagalliTable(
        quasar_name=np.asarray(names),
        right_ascension_deg=np.asarray(ras),
        declination_deg=np.asarray(decs),
        redshift=np.asarray(zs),
        SN_1150A=np.asarray(sns),
        science_primary=np.asarray(prim),
        in_training_set=np.asarray(train),
        classification_outcome=np.asarray(outcome),
        LLS_redshift=np.asarray(z_lls),
    )


@partial(jax.jit, static_argnames=("max_lya", "params"))
def _lls_step(learned, spec, offsets, log_nhi, nhi, key, max_lya, params):
    """One spectrum's null + k-Lya evidences as a single compiled step."""
    model = build_spectrum_model(learned, spec, params)
    result = qmc_log_evidences(
        model, offsets, log_nhi, nhi, key, max_lya, params, profile="lls"
    )
    return null_log_evidence(model), result


@partial(jax.jit, static_argnames=("max_lya", "params"))
def _lls_step_batch(
    learned, specs, offsets, log_nhi, nhi, keys, max_lya, params
):
    """A stacked batch of spectra's null + k-Lya evidences as ONE
    compiled dispatch (vmapped over the spectra axis): batching
    amortizes the per-dispatch host->device argument transfer."""

    def one(spec, key):
        model = build_spectrum_model(learned, spec, params)
        result = qmc_log_evidences(
            model, offsets, log_nhi, nhi, key, max_lya, params,
            profile="lls",
        )
        return null_log_evidence(model), result

    return jax.vmap(one)(specs, keys)


def lls_inference_many(
    learned: LearnedModel,
    specs,
    samples: LyaSamples,
    key: jax.Array,
    max_lya: int,
    params: Parameters,
    max_in_flight: int = 2,
    batch_size: int = 8,
):
    """Pipelined LLS search over many spectra: the learned model and
    sample arrays are device-committed once, spectra are stacked into
    ``batch_size``-wide vmapped dispatches (one host->device transfer
    per batch instead of per spectrum), up to
    ``max_in_flight`` dispatched batches stay in flight ahead of the
    readback (bounding device memory — each result pytree holds the
    (B, S, max_lya) sample likelihoods), and results are read back with
    overlapped async copies.  ``specs`` may be any iterable, e.g. a
    prefetching generator; the per-spectrum PRNG key chain (split once
    per spectrum, in stream order) is identical to the single-spectrum
    path, so results are bit-for-bit reproducible against it.  The
    final short batch is padded by repeating its last spectrum (one
    compiled shape; padding results are dropped).

    :return: list of (null_ev: float, result arrays as numpy) tuples.
    """

    import jax.numpy as jnp

    from ..data.spectrum import stack
    from ..utils.pipeline import pipelined_batches

    learned = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(np.asarray(x))), learned
    )
    offsets = jax.device_put(jnp.asarray(samples.offset_samples))
    log_nhi = jax.device_put(jnp.asarray(samples.log_nhi_samples))
    nhi = jax.device_put(jnp.asarray(samples.nhi_samples))

    def keygen():
        # one split per incoming spectrum, in stream order — identical
        # to the single-spectrum path's key chain (bit-for-bit parity)
        nonlocal key
        while True:
            key, sub = jax.random.split(key)
            yield sub

    def dispatch_fn(chunk, chunk_keys):
        return _lls_step_batch(
            learned,
            stack(chunk),
            offsets,
            log_nhi,
            nhi,
            jnp.stack(chunk_keys),
            max_lya,
            params,
        )

    def finalize_fn(n_real, out):
        null_ev, result = out
        null_np = np.asarray(null_ev)
        res_np = jax.tree.map(np.asarray, result)
        for i in range(n_real):
            yield (float(null_np[i]), jax.tree.map(lambda x: x[i], res_np))

    return pipelined_batches(
        specs, batch_size, max_in_flight, dispatch_fn, finalize_fn,
        aux=keygen(),
    )
