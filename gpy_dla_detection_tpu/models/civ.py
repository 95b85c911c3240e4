"""CIV doublet detection: QMC model evidence + posterior machinery.

Rebuild of the reference's CIV model (reference:
gpy_dla_detection/civ_gp.py:25-268).  The reference only implements
MCMC parameter estimation and leaves the QMC evidence integration
unimplemented (civ_gp.py:248-250 "TODO"); here the same batched QMC
engine as the DLA pipeline marginalizes the 3-parameter CIV posterior
(z_civ, logN_CIV, sigma), so Bayesian model selection null-vs-CIV
actually runs.

The CIV covariance has no absorption-noise term: K = M M^T + V
(reference: civ_gp.py:158-183).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data.samples import halton_sequence
from ..ops.logmvn import batched_log_mvnpdf, log_mvnpdf_low_rank, pair_basis
from ..ops.voigt import voigt_absorption_civ
from ..params import CIVParameters
from .learned import SpectrumModel


class CIVSamples(NamedTuple):
    """QMC samples of (z offset, logN_CIV, sigma)."""

    offset_samples: np.ndarray
    log_nciv_samples: np.ndarray
    nciv_samples: np.ndarray
    sigma_samples: np.ndarray


def generate_civ_samples(
    params: CIVParameters,
    num_samples: int | None = None,
    min_sigma: float = 1e6,
    max_sigma: float = 8e6,
) -> CIVSamples:
    """Uniform priors over logN (reference: civ_gp.py:99-110) and the
    broadening velocity sigma."""
    S = num_samples or params.num_civ_samples
    seq = halton_sequence(S, 3)
    log_n = params.uniform_min_log_nciv + (
        params.uniform_max_log_nciv - params.uniform_min_log_nciv
    ) * seq[:, 1]
    sigma = min_sigma + (max_sigma - min_sigma) * seq[:, 2]
    return CIVSamples(
        offset_samples=seq[:, 0],
        log_nciv_samples=log_n,
        nciv_samples=10.0**log_n,
        sigma_samples=sigma,
    )


def civ_null_log_evidence(model: SpectrumModel) -> jnp.ndarray:
    """log p(D | no CIV): N(y; mu, MM^T + V)
    (reference: civ_gp.py:158-183)."""
    return log_mvnpdf_low_rank(model.y, model.mu, model.M, model.v, model.mask)


def civ_qmc_log_evidence(
    model: SpectrumModel,
    samples: CIVSamples,
    params: CIVParameters,
):
    """log p(D | 1 CIV) by QMC over (z, logN, sigma).

    The reference never implemented this (civ_gp.py:248-250); estimator
    follows the DLA engine: logmeanexp of per-sample likelihoods with a
    1/S Occam factor.
    """
    S = samples.offset_samples.shape[0]
    dtype = model.y.dtype
    offsets = jnp.asarray(samples.offset_samples, dtype)
    nciv = jnp.asarray(samples.nciv_samples, dtype)
    sigma = jnp.asarray(samples.sigma_samples, dtype)

    z_civ = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * offsets

    absorption = voigt_absorption_civ(
        model.padded_wavelengths, nciv, z_civ, sigma, params.num_lines
    )
    lls = batched_log_mvnpdf(
        model.y,
        model.mu,
        model.M,
        jnp.zeros_like(model.v),
        model.v,
        model.mask,
        absorption,
        pair_basis(model.M),
    )
    # the same extra 1/S Occam factor the DLA engine applies to every
    # marginalized absorber (evidence.py; reference: dla_gp.py:155-158)
    log_S = jnp.log(jnp.asarray(S, dtype))
    lls = lls - log_S
    max_ll = jnp.max(lls)
    evidence = max_ll + jnp.log(jnp.mean(jnp.exp(lls - max_ll)))
    return evidence, lls


def civ_model_posterior(
    log_evidence_null, log_evidence_civ, p_civ_prior: float = 0.5
):
    """Two-model posterior P(CIV | D)."""
    lp = np.array(
        [
            float(log_evidence_null) + np.log1p(-p_civ_prior),
            float(log_evidence_civ) + np.log(p_civ_prior),
        ]
    )
    m = lp.max()
    post = np.exp(lp - m)
    post /= post.sum()
    return post[1]


def _civ_step_body(learned, spec, samples, params):
    """One spectrum's null + CIV evidences (shared by the single and
    batched compiled steps)."""
    from .learned import build_spectrum_model

    model = build_spectrum_model(learned, spec, params)
    # the CIV covariance carries no absorption-noise term
    # (reference: civ_gp.py:158-183)
    model = model._replace(omega2=jnp.zeros_like(model.v))
    null_ev = civ_null_log_evidence(model)
    civ_ev, _ = civ_qmc_log_evidence(model, samples, params)
    return null_ev, civ_ev


@partial(jax.jit, static_argnames=("params",))
def _civ_step(learned, spec, samples: CIVSamples, params: CIVParameters):
    """One spectrum's null + CIV evidences as a single compiled step."""
    return _civ_step_body(learned, spec, samples, params)


@partial(jax.jit, static_argnames=("params",))
def _civ_step_batch(learned, specs, samples: CIVSamples, params):
    """A stacked batch of spectra's null + CIV evidences as ONE
    compiled dispatch (vmapped): amortizes the per-dispatch
    host->device transfer over the batch."""

    def one(spec):
        return _civ_step_body(learned, spec, samples, params)

    return jax.vmap(one)(specs)


def civ_inference_many(
    learned,
    specs,
    samples: CIVSamples,
    params: CIVParameters,
    p_civ_prior: float = 0.5,
    max_in_flight: int = 4,
    batch_size: int = 16,
):
    """Pipelined CIV detection over many spectra: the learned model and
    QMC samples are device-committed once, spectra are stacked into
    ``batch_size``-wide vmapped dispatches (one host->device transfer
    per batch instead of per spectrum), up to ``max_in_flight``
    dispatched batches stay in flight, and results are read back with
    overlapped async copies.  ``specs`` may be any iterable, e.g. a
    prefetching generator; the final short batch is padded by repeating
    its last spectrum (one compiled shape; padding results dropped).

    :return: list of (p_civ, log_evidence_null, log_evidence_civ).
    """
    from ..data.spectrum import stack
    from ..utils.pipeline import pipelined_batches

    learned = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(np.asarray(x))), learned
    )
    samples = CIVSamples(
        *[jax.device_put(jnp.asarray(np.asarray(v))) for v in samples]
    )

    def dispatch_fn(chunk, _aux):
        return _civ_step_batch(learned, stack(chunk), samples, params)

    def finalize_fn(n_real, out):
        ne_np, ce_np = np.asarray(out[0]), np.asarray(out[1])
        for i in range(n_real):
            n, c = float(ne_np[i]), float(ce_np[i])
            yield (civ_model_posterior(n, c, p_civ_prior), n, c)

    return pipelined_batches(
        specs, batch_size, max_in_flight, dispatch_fn, finalize_fn
    )
