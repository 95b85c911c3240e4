"""MCMC parameter estimation for DLA and CIV absorbers.

Builds jittable log-posterior functions over absorber parameters and
runs the native ensemble sampler (models/mcmc.py) — the batched
equivalent of the reference's emcee-based ``DLAGP.run_mcmc`` / ``CIVGP.run_mcmc``
(reference: gpy_dla_detection/dla_gp.py:227-309,
log_posterior_mcmc.py:17-96, civ_gp.py:77-156,
civ_log_posterior_mcmc.py:14-102).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..data.samples import GARNETT_FIT, _FIT_UPPER, _gaussian_fit_integral
from ..ops.logmvn import log_mvnpdf_low_rank
from ..ops.voigt import voigt_absorption, voigt_absorption_civ
from ..params import Parameters
from .learned import SpectrumModel
from .mcmc import run_ensemble


def log_nhi_mixture_pdf_jnp(log_nhi, params: Parameters, fit=GARNETT_FIT):
    """jax twin of data.samples.log_nhi_mixture_pdf
    (reference: dla_samples.py:106-131) — the SAME LogNHIFit the QMC
    sampling prior uses (a fitted prior may be passed instead)."""
    Z = float(_gaussian_fit_integral(params.fit_min_log_nhi, _FIT_UPPER, fit))
    fit_pdf = jnp.exp(-fit.A * log_nhi**2 + fit.B * log_nhi + fit.C) / Z
    width = params.uniform_max_log_nhi - params.uniform_min_log_nhi
    uniform = jnp.where(
        (log_nhi >= params.uniform_min_log_nhi)
        & (log_nhi <= params.uniform_max_log_nhi),
        1.0 / width,
        0.0,
    )
    return params.alpha * fit_pdf + (1.0 - params.alpha) * uniform


def make_dla_log_posterior(model: SpectrumModel, params: Parameters, k_dlas: int = 1):
    """Vectorized log posterior over theta = [z_1..z_k, logNHI_1..logNHI_k].

    Uniform prior on z in the spectrum's search range, the Garnett
    mixture prior on logNHI (reference: log_posterior_mcmc.py:17-96).

    :return: function (W, 2k) -> (W,)
    """

    def single(theta):
        z = theta[:k_dlas]
        log_nhi = theta[k_dlas:]
        in_bounds = jnp.all(
            (z > model.min_z_dla)
            & (z < model.max_z_dla)
            & (log_nhi > params.uniform_min_log_nhi)
            & (log_nhi < params.uniform_max_log_nhi)
        )
        lp = jnp.sum(jnp.log(log_nhi_mixture_pdf_jnp(log_nhi, params)))

        absorption = jnp.prod(
            voigt_absorption(
                model.padded_wavelengths, 10.0**log_nhi, z, params.num_lines
            ),
            axis=0,
        )
        ll = log_mvnpdf_low_rank(
            model.y,
            model.mu * absorption,
            model.M * absorption[:, None],
            model.omega2 * absorption**2 + model.v,
            model.mask,
        )
        return jnp.where(in_bounds, lp + ll, -jnp.inf)

    return jax.vmap(single)


def run_dla_mcmc(
    model: SpectrumModel,
    params: Parameters,
    key: jax.Array,
    k_dlas: int = 1,
    nwalkers: int = 32,
    nsamples: int = 5000,
    initial_positions=None,
):
    """Sample the k-DLA posterior (reference: dla_gp.py:227-309).

    :return: (chain (nsamples, W, 2k), log_probs, acceptance_rate)
    """
    if initial_positions is None:
        k_init, key = jax.random.split(key)
        kz, kn = jax.random.split(k_init)
        z0 = jax.random.uniform(
            kz,
            (nwalkers, k_dlas),
            minval=model.min_z_dla,
            maxval=model.max_z_dla,
        )
        n0 = jax.random.uniform(
            kn,
            (nwalkers, k_dlas),
            minval=params.fit_min_log_nhi,
            maxval=params.fit_min_log_nhi + 2.0,
        )
        initial_positions = jnp.concatenate([z0, n0], axis=1)

    log_prob_fn = make_dla_log_posterior(model, params, k_dlas)
    return run_ensemble(key, initial_positions, log_prob_fn, nsamples)


def make_civ_log_posterior(
    model: SpectrumModel,
    params,
    k_civ: int = 1,
    min_log_nciv: float = 12.88,
    max_log_nciv: float = 20.0,
    min_sigma: float = 1e6,
    max_sigma: float = 8e6,
):
    """log posterior over theta = [z, logN, sigma] * k for CIV doublets;
    uniform priors, covariance without the absorption-noise term
    (reference: civ_gp.py:77-156, civ_log_posterior_mcmc.py:14-102)."""

    def single(theta):
        z = theta[0::3]
        log_n = theta[1::3]
        sigma = theta[2::3]
        in_bounds = jnp.all(
            (z > model.min_z_dla)
            & (z < model.max_z_dla)
            & (log_n > min_log_nciv)
            & (log_n < max_log_nciv)
            & (sigma > min_sigma)
            & (sigma < max_sigma)
        )
        absorption = jnp.prod(
            voigt_absorption_civ(
                model.padded_wavelengths, 10.0**log_n, z, sigma, 2
            ),
            axis=0,
        )
        ll = log_mvnpdf_low_rank(
            model.y,
            model.mu * absorption,
            model.M * absorption[:, None],
            model.v,
            model.mask,
        )
        return jnp.where(in_bounds, ll, -jnp.inf)

    return jax.vmap(single)


def run_civ_mcmc(
    model: SpectrumModel,
    params,
    key: jax.Array,
    k_civ: int = 1,
    nwalkers: int = 40,
    nsamples: int = 5000,
    min_log_nciv: float = 12.88,
    max_log_nciv: float = 20.0,
    min_sigma: float = 1e6,
    max_sigma: float = 8e6,
):
    """Sample the CIV posterior (reference: civ_gp.py:77-156)."""
    k_init, key = jax.random.split(key)
    ks = jax.random.split(k_init, 3)
    z0 = jax.random.uniform(
        ks[0], (nwalkers, k_civ), minval=model.min_z_dla, maxval=model.max_z_dla
    )
    n0 = jax.random.uniform(
        ks[1], (nwalkers, k_civ), minval=min_log_nciv, maxval=max_log_nciv
    )
    s0 = jax.random.uniform(
        ks[2], (nwalkers, k_civ), minval=min_sigma, maxval=max_sigma
    )
    pos = jnp.stack([z0, n0, s0], axis=2).reshape(nwalkers, 3 * k_civ)

    log_prob_fn = make_civ_log_posterior(
        model, params, k_civ, min_log_nciv, max_log_nciv, min_sigma, max_sigma
    )
    return run_ensemble(key, pos, log_prob_fn, nsamples)
