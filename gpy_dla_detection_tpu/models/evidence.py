"""Model evidences: null GP and QMC-marginalized k-absorber models.

Batched rewrite of the reference's sequential quasi-Monte-Carlo
marginalization (reference: gpy_dla_detection/dla_gp.py:92-225,
subdla_gp.py:90-222):

* the 10,000 per-sample likelihoods of each level are one batched
  Voigt + Woodbury evaluation (ops/voigt.py, ops/logmvn.py) instead of
  a serial Python loop;
* the single-absorber profiles are computed once and levels k >= 2
  reuse them through gathered elementwise products (the reference
  recomputes every Voigt profile for every chained absorber);
* ``np.random.choice`` importance resampling becomes an explicit-PRNG
  inverse-CDF draw (uniforms against the cumulative weights via the
  chunked count in ops/interp.py — ``jax.random.categorical`` lowers to
  an S x S gumbel argmax; reference: dla_gp.py:209-218);
* NaN-driven control flow (min-z-separation masking, early exit on
  underflow) becomes mask arithmetic (reference: dla_gp.py:164-206).

The level-k evidence matches the reference's estimator exactly:

    log P(D | k) = max_i ll_i + log( mean_{valid i} exp(ll_i - max) )
                   - k * log S

with one 1/S Occam factor per marginalized absorber and the mean taken
over samples that satisfy the 3000 km/s pair-separation cut.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.interp import chunked_searchsorted
from ..ops.kernel_config import resolve_abs_store
from ..ops.logmvn import batched_log_mvnpdf, log_mvnpdf_low_rank, pair_basis
from ..ops.voigt import (
    absorption_from_unit_tau,
    decode_profile_store,
    encode_profile_store,
    voigt_absorption,
    voigt_absorption_lls,
)
from ..params import Parameters
from .learned import SpectrumModel

# absorption-profile families usable in the QMC marginalization:
# "dla" = Lyman series only (reference: voigt.py), "lls" = Lyman series
# plus the Lyman-limit break (reference: voigt_lls.py)
PROFILES = {"dla": voigt_absorption, "lls": voigt_absorption_lls}

# importance resampler for the chained levels.  "multinomial" matches
# the reference's np.random.choice draws (dla_gp.py:209-218);
# "systematic" is the classic low-variance systematic resampler (one
# uniform offset on a stratified comb, then one random rotation):
# per-index counts are within 1 of S * p_i instead of Binomial(S, p_i),
# and the drawn indices are one rotation of a sorted sequence, so the
# chained (S, N) profile-row gathers read memory nearly sequentially.
_RESAMPLER: str = os.environ.get("GPY_DLA_RESAMPLER", "multinomial")
if _RESAMPLER not in ("multinomial", "systematic"):
    raise ValueError(
        f"GPY_DLA_RESAMPLER must be 'multinomial' or 'systematic', "
        f"got {_RESAMPLER!r}"
    )

def _draw_base_indices(key, probs, resampler: str) -> jnp.ndarray:
    """S chained-parent indices ~ Categorical(probs / sum(probs)).

    Both resamplers draw through the same chunked inverse-CDF count
    (ops/interp.chunked_searchsorted; ``jax.random.categorical`` would
    lower to an S x S gumbel argmax).

    The systematic comb is ROTATED by a random shift: slot i of the
    chained level pairs parent ``base[i]`` with the FIXED new sample i,
    so the raw comb's deterministic slot->i-th-quantile coupling is a
    defect here — with near-flat weights ``base[i] == i``, every slot
    chains with itself, the 3000 km/s pair-separation cut invalidates
    all S samples and the level NaNs.  Rolling by a uniform shift keeps
    the marginals exact (each slot's comb position is uniform) and the
    within-1 counts and gather locality intact (one rotation of an
    ascending sequence = two ascending runs).
    """
    S = probs.shape[0]
    dtype = probs.dtype
    cdf = jnp.cumsum(probs)
    if resampler == "systematic":
        k_u, k_r = jax.random.split(key)
        u0 = jax.random.uniform(k_u, (), dtype)
        u = (jnp.arange(S, dtype=dtype) + u0) * (cdf[-1] / S)
        base = jnp.minimum(chunked_searchsorted(cdf, u), S - 1)
        return jnp.roll(base, jax.random.randint(k_r, (), 0, S))
    u = jax.random.uniform(key, (S,), dtype) * cdf[-1]
    return jnp.minimum(chunked_searchsorted(cdf, u), S - 1)


def null_log_evidence(model: SpectrumModel) -> jnp.ndarray:
    """log p(D | no absorber) (reference: null_gp.py:294-305)."""
    return log_mvnpdf_low_rank(
        model.y, model.mu, model.M, model.omega2 + model.v, model.mask
    )


class QMCEvidenceResult(NamedTuple):
    """Everything the catalog writer records per spectrum and model."""

    log_evidences: jnp.ndarray  # (max_k,) log p(D | k absorbers)
    sample_log_likelihoods: jnp.ndarray  # (S, max_k), NaN where invalid
    base_sample_inds: jnp.ndarray  # (max_k - 1, S) resampled indices
    map_z_dlas: jnp.ndarray  # (max_k, max_k) MAP redshifts (NaN padded)
    map_log_nhis: jnp.ndarray  # (max_k, max_k)


def qmc_log_evidences(
    model: SpectrumModel,
    offset_samples: jnp.ndarray,
    log_nhi_samples: jnp.ndarray,
    nhi_samples: jnp.ndarray,
    key: jax.Array,
    max_k: int,
    params: Parameters,
    base_inds_override: jnp.ndarray | None = None,
    profile: str = "dla",
    voigt_impl: str | None = None,
    unit_tau: jnp.ndarray | None = None,
    abs_dtype=None,
) -> QMCEvidenceResult:
    """Marginalize the k-absorber models over the QMC sample set.

    :param model: interpolated spectrum model (one spectrum).
    :param offset_samples: (S,) uniform offsets mapped onto
        [min_z_dla, max_z_dla] (reference: dla_samples.py:94-104).
    :param log_nhi_samples, nhi_samples: (S,) column-density samples.
    :param key: PRNG key driving the importance resampling.
    :param max_k: number of absorber models (static).
    :param base_inds_override: optional (max_k - 1, S) resampling
        indices; replaces the categorical draws (used to reproduce a
        reference run bit-for-bit in conformance tests).
    :param voigt_impl: static Voigt strategy, threaded to ops.voigt
        (None = exact; see ops/kernel_config.py).
    :param unit_tau: optional precomputed (S, P) per-unit-nhi Lyman
        optical depth for THESE offset samples (profile "dla" only).
        The DLA and subDLA sample sets share their redshift offsets
        (reference: multi_dlas/set_lls_parameters.m:22,59), so the
        batch layer computes the expensive Faddeeva factor once and
        passes it to both marginalizations.
    :param abs_dtype: storage of the (S, N) profiles (static): None =
        the pipeline dtype, or an explicit dtype or name
        (ops/kernel_config.resolve_abs_store).
    """
    S = offset_samples.shape[0]
    dtype = model.y.dtype
    log_S = jnp.log(jnp.asarray(S, dtype))
    min_sep = jnp.asarray(params.min_z_separation, dtype)
    store = resolve_abs_store(abs_dtype, dtype, model.y.shape[0])

    z_samples = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * offset_samples
    # chained levels gather the parent's (z, logNHI) pair as ONE
    # 2-column row gather instead of two 1-D gathers
    zn_table = jnp.stack([z_samples, log_nhi_samples], axis=1)  # (S, 2)

    # single-absorber profiles for every sample, computed once: (S, N)
    with jax.named_scope("absorption"):
        if unit_tau is not None and profile == "dla":
            A = absorption_from_unit_tau(unit_tau, nhi_samples, out_dtype=store)
        else:
            A = encode_profile_store(
                PROFILES[profile](
                    model.padded_wavelengths,
                    nhi_samples,
                    z_samples,
                    params.num_lines,
                    impl=voigt_impl,
                ),
                store,
            )

    # the basis is shared by all max_k + 1 likelihood calls
    M_pair = pair_basis(model.M)

    # state threaded through the static level loop
    chained = None  # running product of the chained absorbers' profiles
    z_rows = [z_samples]  # level-k absorber redshifts, one row per chain slot
    lognhi_rows = [log_nhi_samples]
    alive = jnp.asarray(True)
    # previous level's resampling weights: (validity mask, centered lls)
    prev_valid = jnp.ones((S,), dtype=bool)
    prev_ll_centered = jnp.zeros((S,), dtype)

    log_evidences = []
    sample_lls = []
    base_inds_rows = []
    map_z = []
    map_lognhi = []

    keys = jax.random.split(key, max_k)

    for k0 in range(max_k):  # k0 = number of *additional* absorbers
        if k0 > 0:
            with jax.named_scope("resample"):
                if base_inds_override is not None:
                    base = base_inds_override[k0 - 1]
                else:
                    logits = jnp.where(prev_valid, prev_ll_centered, -jnp.inf)
                    # if the previous level underflowed entirely, keep indices
                    # in-range with uniform logits (results are NaN-masked)
                    logits = jnp.where(alive, logits, jnp.zeros_like(logits))
                    probs = jnp.exp(logits - jnp.max(logits))
                    base = _draw_base_indices(keys[k0 - 1], probs, _RESAMPLER)
                base_inds_rows.append(base)
                # chain the resampled absorber by gathering its precomputed
                # profile row instead of a fresh Voigt pass.
                # mode="clip" is load-bearing: jnp.take's default fill mode
                # emits an out-of-bounds select over the gathered output — a
                # full extra (S, N) read+write pass per chained level.  base
                # is in [0, S-1] by construction (_draw_base_indices clips
                # its searchsorted result; base_inds_override comes from
                # stored catalogs), so clip semantics are identical.
                g = decode_profile_store(
                    jnp.take(A, base, axis=0, mode="clip"), dtype
                )
                chained = g if chained is None else chained * g
                zn = jnp.take(zn_table, base, axis=0, mode="clip")  # (S, 2)
                z_rows.append(zn[:, 0])
                lognhi_rows.append(zn[:, 1])

        profiles = A if chained is None else (
            decode_profile_store(A, dtype) * chained
        )
        with jax.named_scope("likelihood"):
            ll = (
                batched_log_mvnpdf(
                    model.y,
                    model.mu,
                    model.M,
                    model.omega2,
                    model.v,
                    model.mask,
                    profiles,
                    M_pair,
                )
                - log_S
            )

        # pair-separation validity (reference: dla_gp.py:164-177)
        if k0 > 0:
            all_z = jnp.sort(jnp.stack(z_rows, axis=0), axis=0)  # (k0+1, S)
            valid = jnp.all(jnp.diff(all_z, axis=0) >= min_sep, axis=0)
        else:
            valid = jnp.ones((S,), dtype=bool)

        max_ll = jnp.max(jnp.where(valid, ll, -jnp.inf))
        ll_centered = ll - max_ll
        n_valid = jnp.sum(valid)
        mean_prob = jnp.sum(jnp.where(valid, jnp.exp(ll_centered), 0.0)) / n_valid
        evidence = max_ll + jnp.log(mean_prob) - k0 * log_S
        prev_valid, prev_ll_centered = valid, ll_centered

        evidence = jnp.where(alive, evidence, jnp.nan)
        alive = alive & jnp.isfinite(evidence)

        log_evidences.append(evidence)
        sample_lls.append(jnp.where(valid & alive, ll, jnp.nan))

        # MAP chain for this level (reference: dla_gp.py:428-472).
        # One-hot masked sums, not r[maxind]: the masked reduction is
        # bit-exact (one nonzero term) and fuses into the level's
        # elementwise work, where a vmapped dynamic scalar gather would
        # be a separate small op per extraction.
        maxind = jnp.argmax(jnp.where(valid, ll, -jnp.inf))
        onehot = jnp.arange(S) == maxind  # (S,) exactly one True
        pick = lambda rows: jnp.sum(
            jnp.where(onehot[None, :], jnp.stack(rows), 0.0), axis=1
        )
        z_chain = pick(z_rows)  # (k0+1,)
        n_chain = pick(lognhi_rows)
        pad = jnp.full((max_k - k0 - 1,), jnp.nan, dtype)
        map_z.append(jnp.concatenate([z_chain, pad]))
        map_lognhi.append(jnp.concatenate([n_chain, pad]))

    base_sample_inds = (
        jnp.stack(base_inds_rows) if base_inds_rows else jnp.zeros((0, S), jnp.int32)
    )
    return QMCEvidenceResult(
        log_evidences=jnp.stack(log_evidences),
        sample_log_likelihoods=jnp.stack(sample_lls, axis=1),
        base_sample_inds=base_sample_inds,
        map_z_dlas=jnp.stack(map_z),
        map_log_nhis=jnp.stack(map_lognhi),
    )
