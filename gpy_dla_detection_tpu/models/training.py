"""Null-model GP training: learn (mu, M, log omega, c0, tau0, beta).

Native rebuild of the MATLAB-only training path (reference:
multi_dlas/learn_qso_model_meanflux.m:1-184,
objective_lyseries.m:1-79, spectrum_loss_lyseries.m:14-92) — the half
of the pipeline the reference's Python package deliberately omits.

Design:

* training spectra are interpolated once onto the shared rest grid
  (host-side), giving a fixed-shape (Q, R) flux matrix with a validity
  mask — the per-spectrum loss is then a masked Woodbury log-density
  identical in structure to the inference kernel;
* the five analytic gradient blocks the reference hand-derives
  (spectrum_loss_lyseries.m:71-91) come free from ``jax.grad``;
* per-spectrum losses are vmapped and summed; the spectra axis is the
  natural data-parallel axis for multi-chip training (psum of
  gradients);
* L-BFGS via optax (the reference uses minFunc's L-BFGS).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..ops.logmvn import LOG_2PI
from ..params import Parameters
from .learned import LearnedModel


class TrainingSet(NamedTuple):
    """Fixed-shape training data on the shared rest-wavelength grid."""

    rest_wavelengths: np.ndarray  # (R,)
    flux: np.ndarray  # (Q, R) mean-flux-lifted, centered later
    noise_variance: np.ndarray  # (Q, R) lifted variance
    mask: np.ndarray  # (Q, R) valid pixels
    lya_1pz: np.ndarray  # (Q, R) (1 + z_lya) per pixel
    zqso_1pz: np.ndarray  # (Q,) 1 + z_qso


class TrainingParams(NamedTuple):
    """The optimized variables (pytree)."""

    M: jnp.ndarray  # (R, k)
    log_omega: jnp.ndarray  # (R,)
    log_c_0: jnp.ndarray
    log_tau_0: jnp.ndarray
    log_beta: jnp.ndarray


def _mean_flux_suppression_np(obs_wl, beta, tau_0, z_qso, num_forest_lines):
    """Host-numpy twin of ``ops.optical_depth.mean_flux_suppression``
    for the one-time training-set preparation: the jnp op dispatches
    eagerly to the default device, and a per-spectrum host loop would
    pay a device round trip per call (Q = 65k at reference scale).
    Synchronization with the
    inference op is pinned by tests/test_training.py."""
    lam = np.asarray(C.LYMAN_WAVELENGTHS_A[:num_forest_lines], np.float64)
    osc = np.asarray(C.LYMAN_OSCILLATOR_STRENGTHS[:num_forest_lines], np.float64)
    one_plus_z = obs_wl[..., None] / lam  # (..., P, L)
    scale = tau_0 * osc / osc[0] * lam / lam[0]
    tau = scale * one_plus_z**beta * (one_plus_z - 1.0 <= z_qso)
    return np.exp(-np.sum(tau, axis=-1))


def prepare_training_set(
    params: Parameters,
    wavelengths_list,
    flux_list,
    noise_variance_list,
    pixel_mask_list,
    z_qsos,
) -> TrainingSet:
    """Interpolate observed spectra onto the rest grid and lift the
    Kim et al. mean flux (reference: learn_qso_model_meanflux.m:42-126).
    Host-side, runs once."""
    rest_grid = np.arange(
        params.min_lambda, params.max_lambda + params.dlambda / 2, params.dlambda
    )
    R = rest_grid.shape[0]
    Q = len(wavelengths_list)

    flux_out = np.zeros((Q, R))
    var_out = np.ones((Q, R))
    mask_out = np.zeros((Q, R), dtype=bool)
    lya_1pz = np.ones((Q, R))

    for i in range(Q):
        wl = np.asarray(wavelengths_list[i], np.float64)
        fx = np.asarray(flux_list[i], np.float64)
        nv = np.asarray(noise_variance_list[i], np.float64)
        pm = np.asarray(pixel_mask_list[i], bool)
        z = float(z_qsos[i])

        rest = wl / (1.0 + z)
        good = (~pm) & np.isfinite(fx) & np.isfinite(nv)
        if not np.any(good):
            # one unusable spectrum contributes an all-masked row (the
            # MATLAB reference's NaNs are absorbed by the mask) instead
            # of aborting the whole host-side preparation
            continue

        # linear interpolation onto the rest grid; grid points outside
        # the observed range or straddling bad pixels are masked
        f = np.interp(rest_grid, rest[good], fx[good], left=np.nan, right=np.nan)
        v = np.interp(rest_grid, rest[good], nv[good], left=np.nan, right=np.nan)
        in_range = (rest_grid >= rest[good].min()) & (rest_grid <= rest[good].max())
        ok = in_range & np.isfinite(f) & np.isfinite(v) & (v <= params.max_noise_variance)

        obs_wl = rest_grid * (1.0 + z)
        one_pz = obs_wl / C.LYA_WAVELENGTH_A  # 1 + z_lya per pixel

        # lift the mean-flux suppression over the full Lyman series —
        # same formula build_spectrum_model applies at inference time
        # (ops/optical_depth.py; the numpy twin is test-pinned to it)
        a = _mean_flux_suppression_np(
            obs_wl, params.prev_beta, params.prev_tau_0, z,
            params.num_forest_lines,
        )

        flux_out[i, ok] = f[ok] / a[ok]
        var_out[i, ok] = v[ok] / a[ok] ** 2
        mask_out[i] = ok
        lya_1pz[i] = one_pz

    return TrainingSet(
        rest_wavelengths=rest_grid,
        flux=flux_out,
        noise_variance=var_out,
        mask=mask_out,
        lya_1pz=lya_1pz,
        zqso_1pz=1.0 + np.asarray(z_qsos, np.float64),
    )


def initialize(params: Parameters, train: TrainingSet) -> tuple[np.ndarray, TrainingParams]:
    """Empirical mean + PCA initialization
    (reference: learn_qso_model_meanflux.m:130-160).

    Rest-grid columns never observed by ANY training spectrum get
    finite placeholders (mu = 1, omega at the 1e-3 floor): their loss
    contribution is masked out, but a NaN parameter would poison optax
    L-BFGS's inner products and silently NaN the whole fit
    (np.maximum(nan, 1e-3) is nan)."""
    counts = train.mask.sum(axis=0)
    safe = np.maximum(counts, 1)
    filled_flux = np.where(train.mask, train.flux, 0.0)
    mu = filled_flux.sum(axis=0) / safe
    mu = np.where(counts > 0, mu, 1.0)
    centered = np.where(train.mask, train.flux - mu, 0.0)

    # top-k principal components scaled by sqrt(eigenvalue)
    _, s, vt = np.linalg.svd(centered, full_matrices=False)
    Q = train.flux.shape[0]
    M0 = (vt[: params.k].T * (s[: params.k] / np.sqrt(Q)))

    var = (centered**2).sum(axis=0) / safe
    log_omega0 = np.log(np.maximum(np.sqrt(var), 1e-3))

    return mu, TrainingParams(
        M=jnp.asarray(M0),
        log_omega=jnp.asarray(log_omega0),
        log_c_0=jnp.asarray(np.log(params.initial_c_0)),
        log_tau_0=jnp.asarray(np.log(params.initial_tau_0)),
        log_beta=jnp.asarray(np.log(params.initial_beta)),
    )


def _forest_optical_depth(lya_1pz, zqso_1pz, tau_0, beta, num_forest_lines: int):
    """Approximate Lyman-series optical depth from the Lya pixel
    redshifts via the oscillator-strength scaling relationship
    (reference: spectrum_loss_lyseries.m:22-44).

    The atomic constants enter as Python floats (weak types): under
    globally-enabled x64 a raw numpy-f64 scalar would promote the whole
    (Q, R) tau pipeline — and the matmuls fed from it — to f64, several
    times slower than f32 on the accelerator."""
    lam = [float(x) for x in C.LYMAN_WAVELENGTHS_A[:num_forest_lines]]
    osc = [float(x) for x in C.LYMAN_OSCILLATOR_STRENGTHS[:num_forest_lines]]
    tau_total = tau_0 * lya_1pz**beta
    for i in range(1, num_forest_lines):
        lyman_1pz = lam[0] * lya_1pz / lam[i]
        indicator = lyman_1pz - 1.0 <= zqso_1pz[..., None] - 1.0
        lyman_1pz = lyman_1pz * indicator
        scale = tau_0 * lam[i] * osc[i] / (lam[0] * osc[0])
        tau_total = tau_total + scale * lyman_1pz**beta
    return tau_total


def spectrum_loss(
    y, lya_1pz, noise_variance, mask, zqso_1pz, p: TrainingParams,
    num_forest_lines: int,
):
    """Negative log likelihood of one centered spectrum:
        -log N(y; 0, MM' + diag(v + omega2 (1 - exp(-tau) + c0)^2))
    (reference: spectrum_loss_lyseries.m:14-69).  Masked pixels drop out.
    """
    omega2 = jnp.exp(2.0 * p.log_omega)
    c_0 = jnp.exp(p.log_c_0)
    tau_0 = jnp.exp(p.log_tau_0)
    beta = jnp.exp(p.log_beta)

    tau = _forest_optical_depth(lya_1pz, zqso_1pz, tau_0, beta, num_forest_lines)
    scaling = 1.0 - jnp.exp(-tau) + c_0
    d = noise_variance + omega2 * scaling**2

    delta = jnp.where(mask, y, 0.0)
    d_safe = jnp.where(mask, d, 1.0)
    d_inv = jnp.where(mask, 1.0 / d_safe, 0.0)

    k = p.M.shape[-1]
    D_inv_M = p.M * d_inv[..., None]
    B = jnp.eye(k, dtype=y.dtype) + jnp.matmul(
        p.M.T, D_inv_M, precision=jax.lax.Precision.HIGHEST
    )
    L = jnp.linalg.cholesky(B)
    u = jnp.matmul(p.M.T, d_inv * delta, precision=jax.lax.Precision.HIGHEST)
    t = jax.scipy.linalg.solve_triangular(L, u, lower=True)

    quad = jnp.sum(delta * delta * d_inv) - jnp.sum(t * t)
    log_det = jnp.sum(jnp.where(mask, jnp.log(d_safe), 0.0)) + 2.0 * jnp.sum(
        jnp.log(jnp.diag(L))
    )
    n = jnp.sum(mask)
    return 0.5 * (quad + log_det + n * LOG_2PI)


def batched_spectrum_losses(
    p: TrainingParams, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz,
    num_forest_lines: int,
):
    """All per-spectrum negative log likelihoods as one batched
    computation: the (Q, k, k) capacitance matrices come from a single
    (Q, R) x (R, k^2) matmul against the outer-product basis of M, and
    the Q small Cholesky factorizations run as the unrolled rank-1
    chain (``ops.logmvn.batched_quad_logdet``), as in the inference
    path.  Mathematically identical to vmapping
    ``spectrum_loss`` (pinned by tests/test_training.py).
    """
    from ..ops.logmvn import batched_quad_logdet

    omega2 = jnp.exp(2.0 * p.log_omega)
    c_0 = jnp.exp(p.log_c_0)
    tau_0 = jnp.exp(p.log_tau_0)
    beta = jnp.exp(p.log_beta)

    tau = _forest_optical_depth(lya_1pz, zqso_1pz, tau_0, beta, num_forest_lines)
    scaling = 1.0 - jnp.exp(-tau) + c_0
    d = noise_variance + omega2 * scaling**2  # (Q, R)

    delta = jnp.where(mask, flux_centered, 0.0)
    d_safe = jnp.where(mask, d, 1.0)
    d_inv = jnp.where(mask, 1.0 / d_safe, 0.0)

    k = p.M.shape[-1]
    M_pair = (p.M[:, :, None] * p.M[:, None, :]).reshape(p.M.shape[0], k * k)
    B = jnp.eye(k, dtype=delta.dtype) + jnp.matmul(
        d_inv, M_pair, precision=jax.lax.Precision.HIGHEST
    ).reshape(-1, k, k)  # (Q, k, k)
    u = jnp.matmul(
        d_inv * delta, p.M, precision=jax.lax.Precision.HIGHEST
    )  # (Q, k)

    corr, log_det_B = batched_quad_logdet(B, u)
    quad = jnp.sum(delta * delta * d_inv, axis=-1) - corr
    log_det = jnp.sum(jnp.where(mask, jnp.log(d_safe), 0.0), axis=-1) + log_det_B
    n = jnp.sum(mask, axis=-1)
    return 0.5 * (quad + log_det + n * LOG_2PI)  # (Q,)


def total_objective(
    p: TrainingParams,
    flux_centered,
    lya_1pz,
    noise_variance,
    mask,
    zqso_1pz,
    params: Parameters,
):
    """Sum of per-spectrum losses plus the Gaussian priors on tau_0 and
    beta (reference: objective_lyseries.m:42-76)."""
    losses = batched_spectrum_losses(
        p, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz,
        params.num_forest_lines,
    )
    nlog_p = jnp.sum(losses)

    # Kim et al. (2007) priors
    tau_0_mu, tau_0_sigma = 0.0023, 0.0007
    beta_mu, beta_sigma = 3.65, 0.21
    tau_0 = jnp.exp(p.log_tau_0)
    beta = jnp.exp(p.log_beta)
    nlog_p = nlog_p + 0.5 * ((tau_0 - tau_0_mu) / tau_0_sigma) ** 2
    nlog_p = nlog_p + 0.5 * ((beta - beta_mu) / beta_sigma) ** 2
    return nlog_p


@partial(jax.jit, static_argnames=("params", "num_iterations", "objective"))
def fit_lbfgs(
    p0: TrainingParams,
    flux_centered,
    lya_1pz,
    noise_variance,
    mask,
    zqso_1pz,
    params: Parameters,
    num_iterations: int = 200,
    objective=None,
):
    """L-BFGS maximum-likelihood fit (reference: minFunc L-BFGS,
    learn_qso_model_meanflux.m:161-162).  ``objective`` overrides the
    loss (same signature as ``total_objective``; benchmarks only)."""
    import optax

    obj = total_objective if objective is None else objective

    def loss_fn(p):
        return obj(
            p, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz, params
        )

    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(loss_fn)

    def step(carry, _):
        p, state = carry
        value, grad = value_and_grad(p, state=state)
        updates, state = opt.update(
            grad, state, p, value=value, grad=grad, value_fn=loss_fn
        )
        p = optax.apply_updates(p, updates)
        return (p, state), value

    (p_final, _), values = jax.lax.scan(
        step, (p0, opt.init(p0)), None, length=num_iterations
    )
    return p_final, values


def fit_lbfgs_stepwise(
    p0: TrainingParams,
    flux_centered,
    lya_1pz,
    noise_variance,
    mask,
    zqso_1pz,
    params: Parameters,
    num_iterations: int = 200,
    objective=None,
    callback=None,
    callback_every: int = 50,
):
    """Step-granular L-BFGS: ONE jitted step dispatched from a Python
    loop (reference: minFunc's per-iteration loop,
    learn_qso_model.m:100-123).

    Why not the ``fit_lbfgs`` whole-scan: a reference-scale run is
    2,000 iterations, and the scan variant's compile time scales
    linearly with scan length under the full-scale configuration,
    while the stepwise variant compiles once.  Stepwise also surfaces per-iteration values on the
    host, enabling progress logs, step-granular checkpoints, and
    restart-with-reshift schedules (scripts/train_fullscale.py).

    ``callback(i, value)`` is invoked every ``callback_every``
    iterations (value already synced); returning True stops early.
    Returns ``(p_final, values)`` with values as a host f64 array.
    """
    import optax

    obj = total_objective if objective is None else objective
    opt = optax.lbfgs()

    # The training arrays are threaded through the jitted step as
    # ARGUMENTS, never captured: a closure would bake them into the
    # lowered program as constants, and at reference scale (65k x 1217
    # x 5 arrays ~ 1.6 GB) compile time and program size would scale
    # with the data, while the argument-passing variant compiles from
    # shapes alone.
    @jax.jit
    def step(p, state, data):
        def loss_fn(pp):
            return obj(pp, *data, params)

        value, grad = optax.value_and_grad_from_state(loss_fn)(
            p, state=state
        )
        updates, state = opt.update(
            grad, state, p, value=value, grad=grad, value_fn=loss_fn
        )
        p = optax.apply_updates(p, updates)
        return p, state, value

    data = (flux_centered, lya_1pz, noise_variance, mask, zqso_1pz)
    p, state = p0, opt.init(p0)
    values = []
    for i in range(num_iterations):
        p, state, v = step(p, state, data)
        values.append(v)
        if callback is not None and (i + 1) % callback_every == 0:
            if callback(i, float(v)):
                break
    values = np.asarray(jax.device_get(values), np.float64)
    return p, values


def save_training_checkpoint(path: str, p: TrainingParams, mu, step: int) -> None:
    """Step-granular training checkpoint (the reference has none — its
    recovery is stage-granular .mat artifacts)."""
    np.savez(
        path,
        step=step,
        mu=np.asarray(mu),
        **{name: np.asarray(getattr(p, name)) for name in TrainingParams._fields},
    )


def load_training_checkpoint(path: str):
    """:return: (TrainingParams, mu, step)"""
    with np.load(path) as f:
        p = TrainingParams(*[jnp.asarray(f[name]) for name in TrainingParams._fields])
        return p, f["mu"], int(f["step"])


def train_model(
    params: Parameters,
    train: TrainingSet,
    num_iterations: int = 200,
    dtype=jnp.float64,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
) -> tuple[LearnedModel, np.ndarray]:
    """Full training: init, optimize, package as a LearnedModel.

    With ``checkpoint_path`` + ``checkpoint_every``, optimization runs in
    chunks, persists the parameters after each chunk, and resumes from
    an existing checkpoint file.

    :return: (learned_model, loss_history)
    """
    start_step = 0
    import os

    if checkpoint_path and os.path.exists(checkpoint_path):
        p0, mu, start_step = load_training_checkpoint(checkpoint_path)
        print(f"[train] resuming from {checkpoint_path} at step {start_step}")
    else:
        mu, p0 = initialize(params, train)

    flux_centered = jnp.asarray(
        np.where(train.mask, train.flux - mu, 0.0), dtype
    )
    p0 = TrainingParams(*[jnp.asarray(x, dtype) for x in p0])
    args = (
        flux_centered,
        jnp.asarray(train.lya_1pz, dtype),
        jnp.asarray(train.noise_variance, dtype),
        jnp.asarray(train.mask),
        jnp.asarray(train.zqso_1pz, dtype),
    )

    if checkpoint_path and checkpoint_every:
        values_all = []
        p_final = p0
        step = start_step
        while step < num_iterations:
            chunk = min(checkpoint_every, num_iterations - step)
            p_final, values = fit_lbfgs(p_final, *args, params, chunk)
            values_all.append(np.asarray(values))
            step += chunk
            save_training_checkpoint(checkpoint_path, p_final, mu, step)
        values = np.concatenate(values_all) if values_all else np.zeros(0)
    else:
        p_final, values = fit_lbfgs(p0, *args, params, num_iterations)

    learned = LearnedModel(
        rest_wavelengths=train.rest_wavelengths,
        mu=np.asarray(mu),
        M=np.asarray(p_final.M),
        log_omega=np.asarray(p_final.log_omega),
        log_c_0=np.asarray(p_final.log_c_0),
        log_tau_0=np.asarray(p_final.log_tau_0),
        log_beta=np.asarray(p_final.log_beta),
        prev_tau_0=np.float64(params.prev_tau_0),
        prev_beta=np.float64(params.prev_beta),
    )
    return learned, np.asarray(values)
