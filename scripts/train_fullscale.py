"""Reference-scale GP training, executed on the accelerator.

The reference trains its null GP with MATLAB minFunc L-BFGS — 2,000
iterations over the full DR12Q training set (~tens of thousands of
spectra) on a multicore CPU node (reference:
multi_dlas/learn_qso_model_meanflux.m:161-184, minFunc settings at
:100-123 of learn_qso_model.m).  This script runs the complete thing —
65k synthetic spectra, the full 2,000-iteration L-BFGS with zoom line
search — on one device and records a JSON artifact:

* wall time per stage (generate / prepare / fit) and ms per iteration,
* the loss trajectory (downsampled; only its finiteness is asserted),
* recovered-model quality vs the GENERATING model: mu RMSE, the
  principal angles between the learned and generating low-rank
  subspaces, omega RMSE,
* an end-to-end detection gate: the full Bayes pipeline runs with the
  TRAINED model on held-out spectra (half with injected DLAs) — the
  gate the reference's own acceptance tests apply to its shipped model
  (reference: tests/test_selection.py:428-452, tolerances there).

Memory note: at Q=65k the objective's (Q, R) intermediates are chunked
with ``jax.checkpoint`` (16 chunks) so the reverse pass holds one
chunk's residuals instead of ~20 GB of (65k, 1217) temporaries.

Precision note (why all-f32 with a SHIFTED objective, not f64): the
zoom line search's Wolfe comparisons must resolve per-iteration
decrements (~1e1-1e2) against a total loss of ~5e7, which f32 ulp
(~4 at 5e7) swallows.  The first cut kept f64 MASTER parameters for
this, which made the whole optax L-BFGS state arithmetic f64 (slow
on the accelerator) and its compile time linear in the scan length.
But the Wolfe test
``f(x+td) <= f(x) + c1 t g.d`` is invariant under adding a CONSTANT to
the objective, so instead the per-spectrum losses are shifted by a
trace-time constant near their current mean: the summed value's
magnitude stays ~1e4-1e6 (f32 ulp 1e-3-1e-1, far below the
decrements), and every array including the optimizer state stays f32
(scripts/train_throughput.py times that path).  A second stage re-shifts at the
stage-A optimum and RESTARTS the optimizer (fresh L-BFGS state, so no
stale Wolfe cache sees the changed constant) — late-training
decrements are then resolved at ulp(|value since re-shift|) ~ 1e-2.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gpy_dla_detection_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np


def generate_observations(params, learned, Q, seed0=1000, z_range=(2.3, 4.4)):
    """Q DLA-free sightlines from the generating model (the reference
    trains on the DLA-free prior subset, model_priors.py:85-92)."""
    from gpy_dla_detection_tpu.data.synthetic import synthetic_observation

    rng = np.random.default_rng(7)
    zs = rng.uniform(*z_range, size=Q)
    wl_l, fx_l, nv_l, pm_l = [], [], [], []
    for i in range(Q):
        wl, fx, nv, pm = synthetic_observation(
            params, learned, float(zs[i]), seed=seed0 + i, with_omega_noise=True
        )
        wl_l.append(wl)
        fx_l.append(fx)
        nv_l.append(nv)
        pm_l.append(pm)
    return wl_l, fx_l, nv_l, pm_l, zs


def chunked_objective_factory(n_chunks: int, shift_per_spectrum: float = 0.0):
    """total_objective with the Q axis scanned in checkpointed chunks
    and each per-spectrum loss shifted by the trace-time constant
    ``shift_per_spectrum`` (see module docstring Precision note: the
    shift keeps the f32 value small enough that the zoom line search's
    Wolfe comparisons resolve the decrements; the true loss is
    ``value + Q * shift_per_spectrum``, restored on the host in f64)."""
    from gpy_dla_detection_tpu.models.training import batched_spectrum_losses

    shift = float(shift_per_spectrum)

    def objective(p, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz,
                  params):
        Q = flux_centered.shape[0]
        assert Q % n_chunks == 0, (Q, n_chunks)
        Qc = Q // n_chunks
        xs = tuple(
            x.reshape(n_chunks, Qc, *x.shape[1:])
            for x in (flux_centered, lya_1pz, noise_variance, mask, zqso_1pz)
        )

        losses_fn = jax.checkpoint(
            lambda pp, fc, ly, v, m, zq: batched_spectrum_losses(
                pp, fc, ly, v, m, zq, params.num_forest_lines
            )
        )

        def body(acc, x):
            fc, ly, v, m, zq = x
            # subtract the shift PER SPECTRUM before summing: the chunk
            # partial sums are then O(|per-spectrum deviation| * sqrt(Qc))
            # instead of O(|mean loss| * Qc), so the f32 accumulation
            # carries full precision where the line search needs it
            return acc + jnp.sum(losses_fn(p, fc, ly, v, m, zq) - shift), None

        total, _ = jax.lax.scan(body, jnp.float32(0.0), xs)

        # Kim et al. (2007) priors (reference: objective_lyseries.m:64-76)
        tau_0 = jnp.exp(p.log_tau_0)
        beta = jnp.exp(p.log_beta)
        total = total + 0.5 * ((tau_0 - 0.0023) / 0.0007) ** 2
        total = total + 0.5 * ((beta - 3.65) / 0.21) ** 2
        return total

    return objective


def mean_spectrum_loss(objective_args, params, n_chunks: int) -> float:
    """Mean per-spectrum loss at the current parameters, accumulated on
    the host in f64 (one chunked forward pass; used to pick the shift)."""
    from gpy_dla_detection_tpu.models.training import batched_spectrum_losses

    p, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz = objective_args
    Q = flux_centered.shape[0]
    Qc = Q // n_chunks
    fn = jax.jit(
        lambda pp, fc, ly, v, m, zq: jnp.sum(
            batched_spectrum_losses(pp, fc, ly, v, m, zq,
                                    params.num_forest_lines)
        )
    )
    total = 0.0
    for c in range(n_chunks):
        s = slice(c * Qc, (c + 1) * Qc)
        total += float(fn(p, flux_centered[s], lya_1pz[s],
                          noise_variance[s], mask[s], zqso_1pz[s]))
    return total / Q


def subspace_principal_angles(A, B):
    """Principal angles (degrees) between span(A) and span(B)."""
    qa, _ = np.linalg.qr(np.asarray(A, np.float64))
    qb, _ = np.linalg.qr(np.asarray(B, np.float64))
    s = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return np.degrees(np.arccos(np.clip(s, -1.0, 1.0)))


def detection_gate(params, learned_trained, learned_true, n=100, seed0=90000):
    """Full Bayes model selection with the TRAINED model on held-out
    spectra, half carrying injected DLAs (logNHI 20.8-21.6)."""
    from gpy_dla_detection_tpu.data.samples import (
        generate_dla_samples, generate_subdla_samples)
    from gpy_dla_detection_tpu.data.spectrum import preprocess
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_observation, synthetic_prior_catalog)
    from gpy_dla_detection_tpu.models.learned import build_spectrum_model
    from gpy_dla_detection_tpu.models.evidence import null_log_evidence
    from gpy_dla_detection_tpu.parallel.batch import process_batch

    rng = np.random.default_rng(99)
    dla_samples = generate_dla_samples(params)
    sub_samples = generate_subdla_samples(params)
    prior = synthetic_prior_catalog(params)

    spectra, truths = [], []
    null_deltas = []
    for i in range(n):
        z = float(rng.uniform(2.6, 3.8))
        if i % 2:
            z_dla = float(rng.uniform(z - 0.7, z - 0.1))
            log_nhi = float(rng.uniform(20.8, 21.6))
            dlas = [(z_dla, log_nhi)]
        else:
            dlas = None
        wl, fx, nv, pm = synthetic_observation(
            params, learned_true, z, seed=seed0 + i, dlas=dlas
        )
        spec = preprocess(wl, fx, nv, pm, z, params)
        spectra.append(spec)
        truths.append(dlas)
        if dlas is None:
            # null-evidence agreement, trained vs generating model
            ev_t = float(null_log_evidence(build_spectrum_model(
                learned_trained.astype(jnp.float32), spec, params)))
            ev_g = float(null_log_evidence(build_spectrum_model(
                learned_true.astype(jnp.float32), spec, params)))
            null_deltas.append(ev_t - ev_g)

    results = process_batch(
        learned_trained, spectra, dla_samples, sub_samples, prior, params,
        jax.random.PRNGKey(0), max_dlas=4, dtype=jnp.float32,
    )

    det, fp, z_errs = [], [], []
    for r, truth in zip(results, truths):
        if truth is not None:
            det.append(r.p_dla > 0.9)
            k_map = int(np.argmax(r.selection.model_posteriors)) - 2
            if k_map >= 0:
                z_map = float(np.asarray(r.map_z_dlas)[k_map, 0])
                z_errs.append(abs(z_map - truth[0][0]))
        else:
            fp.append(r.p_dla > 0.5)
    return {
        "n_injected": len(det),
        "detection_rate_p0.9": float(np.mean(det)),
        "false_positive_rate_p0.5": float(np.mean(fp)),
        "map_z_abs_err_median": float(np.median(z_errs)) if z_errs else None,
        "map_z_abs_err_max": float(np.max(z_errs)) if z_errs else None,
        "null_evidence_delta_trained_minus_true_mean": float(np.mean(null_deltas)),
        "null_evidence_delta_trained_minus_true_max_abs": float(
            np.max(np.abs(null_deltas))
        ),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-spectra", type=int, default=65024,
                    help="training-set size (multiple of --chunks)")
    ap.add_argument("--iters", type=int, default=2000,
                    help="L-BFGS iterations (the minFunc setting)")
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--gate-n", type=int, default=100)
    ap.add_argument("--single-stage", action="store_true",
                    help="one shift stage (one compile; see comment)")
    ap.add_argument("--output", default="train_fullscale.json")
    ap.add_argument(
        "--cache", default=None,
        help="npz path for the prepared training set (generation + "
        "rest-grid prep take ~6 min at Q=65k; cache to iterate on the "
        "fit stage)",
    )
    args = ap.parse_args()

    from gpy_dla_detection_tpu.data.synthetic import synthetic_learned_model
    from gpy_dla_detection_tpu.models.training import (
        TrainingParams, fit_lbfgs_stepwise, initialize, prepare_training_set)
    from gpy_dla_detection_tpu.models.learned import LearnedModel
    from gpy_dla_detection_tpu.params import Parameters

    params = Parameters()
    learned_true = synthetic_learned_model(params)
    backend = jax.default_backend()
    print(f"[train_fullscale] backend={backend} Q={args.num_spectra} "
          f"iters={args.iters}", flush=True)

    from gpy_dla_detection_tpu.models.training import TrainingSet

    if args.cache and os.path.exists(args.cache):
        with np.load(args.cache) as f:
            train = TrainingSet(**{k: f[k] for k in TrainingSet._fields})
        assert train.flux.shape[0] == args.num_spectra, train.flux.shape
        t_gen = t_prep = 0.0
        print(f"[train_fullscale] loaded cached training set from "
              f"{args.cache}", flush=True)
    else:
        t0 = time.time()
        wl_l, fx_l, nv_l, pm_l, zs = generate_observations(
            params, learned_true, args.num_spectra
        )
        t_gen = time.time() - t0
        print(f"[train_fullscale] generated {args.num_spectra} spectra in "
              f"{t_gen:.0f}s", flush=True)

        t0 = time.time()
        train = prepare_training_set(params, wl_l, fx_l, nv_l, pm_l, zs)
        del wl_l, fx_l, nv_l, pm_l
        t_prep = time.time() - t0
        print(f"[train_fullscale] prepared rest-grid set "
              f"(R={train.rest_wavelengths.shape[0]}) in {t_prep:.0f}s",
              flush=True)
        if args.cache:
            np.savez(args.cache, **train._asdict())
            print(f"[train_fullscale] cached training set to {args.cache}",
                  flush=True)

    t0 = time.time()
    mu, p0 = initialize(params, train)
    print(f"[train_fullscale] PCA/mean init in {time.time() - t0:.0f}s",
          flush=True)
    dtype = jnp.float32
    t0 = time.time()
    flux_centered = jnp.asarray(np.where(train.mask, train.flux - mu, 0.0), dtype)
    fit_args = (
        flux_centered,
        jnp.asarray(train.lya_1pz, dtype),
        jnp.asarray(train.noise_variance, dtype),
        jnp.asarray(train.mask),
        jnp.asarray(train.zqso_1pz, dtype),
    )
    for a in (flux_centered, *fit_args[1:]):
        a.block_until_ready()
    print(f"[train_fullscale] device transfer in {time.time() - t0:.0f}s",
          flush=True)
    p0 = TrainingParams(*[jnp.asarray(x, jnp.float32) for x in p0])
    Q = args.num_spectra

    # Two-stage shifted-f32 schedule (see module docstring): stage A at
    # the p0 shift burns down the bulk of the loss; stage B re-shifts at
    # the stage-A optimum and RESTARTS L-BFGS, so the late decrements
    # are resolved at ulp(|value since re-shift|).  --single-stage runs
    # everything at the p0 shift (one compile instead of two — each
    # full-scale compile costs ~10 min through the remote-compile
    # service; late decrements then resolve at ulp(|total decrease|),
    # ~0.5 at Q=65k, which the trajectory in the artifact quantifies).
    if args.single_stage:
        stage_a = args.iters
    else:
        stage_a = min(args.iters, max(100, args.iters // 5))
    stage_b = args.iters - stage_a

    t0 = time.time()
    shift0 = mean_spectrum_loss((p0, *fit_args), params, args.chunks)
    print(f"[train_fullscale] shift A = {shift0:.3f} / spectrum", flush=True)

    def progress(tag):
        t_start = time.time()

        def cb(i, v):
            print(f"[train_fullscale] {tag} iter {i + 1}: shifted loss "
                  f"{v:.3f} ({(time.time() - t_start) / (i + 1) * 1e3:.0f} "
                  f"ms/iter)", flush=True)
            return False

        return cb

    p_a, values_a = fit_lbfgs_stepwise(
        p0, *fit_args, params, stage_a,
        objective=chunked_objective_factory(args.chunks, shift0),
        callback=progress("stage A"), callback_every=100,
    )
    values = np.float64(values_a) + Q * shift0

    if stage_b > 0:
        shift1 = mean_spectrum_loss((p_a, *fit_args), params, args.chunks)
        print(f"[train_fullscale] shift B = {shift1:.3f} / spectrum "
              f"(stage A moved the mean loss by {shift1 - shift0:.3f})",
              flush=True)
        p_final, values_b = fit_lbfgs_stepwise(
            p_a, *fit_args, params, stage_b,
            objective=chunked_objective_factory(args.chunks, shift1),
            callback=progress("stage B"), callback_every=100,
        )
        values = np.concatenate([values, np.float64(values_b) + Q * shift1])
    else:
        p_final = p_a

    p_final = jax.tree.map(np.asarray, p_final)
    t_fit = time.time() - t0
    assert np.isfinite(values).all(), "loss trajectory has non-finite entries"
    print(f"[train_fullscale] {args.iters} L-BFGS iterations in {t_fit:.0f}s "
          f"({t_fit / args.iters * 1e3:.1f} ms/iter); loss "
          f"{values[0]:.6g} -> {values[-1]:.6g}", flush=True)

    learned_trained = LearnedModel(
        rest_wavelengths=train.rest_wavelengths,
        mu=np.asarray(mu),
        M=np.asarray(p_final.M, np.float64),
        log_omega=np.asarray(p_final.log_omega, np.float64),
        log_c_0=np.float64(p_final.log_c_0),
        log_tau_0=np.float64(p_final.log_tau_0),
        log_beta=np.float64(p_final.log_beta),
        prev_tau_0=np.float64(params.prev_tau_0),
        prev_beta=np.float64(params.prev_beta),
    )

    # ---- recovered-model quality vs the generating model ----
    grid = train.rest_wavelengths
    mu_true = np.interp(grid, learned_true.rest_wavelengths, learned_true.mu)
    M_true = np.stack(
        [np.interp(grid, learned_true.rest_wavelengths, learned_true.M[:, j])
         for j in range(learned_true.M.shape[1])], axis=1)
    angles = subspace_principal_angles(np.asarray(p_final.M), M_true)
    omega_true = np.interp(
        grid, learned_true.rest_wavelengths, np.exp(learned_true.log_omega))
    quality = {
        "mu_rmse_vs_generating": float(np.sqrt(np.mean((mu - mu_true) ** 2))),
        "mu_rms": float(np.sqrt(np.mean(mu_true**2))),
        "M_subspace_principal_angles_deg_quartiles": [
            float(np.percentile(angles, q)) for q in (25, 50, 75, 100)
        ],
        "omega_rmse_vs_generating": float(
            np.sqrt(np.mean((np.exp(p_final.log_omega) - omega_true) ** 2))
        ),
        "recovered_tau_0": float(np.exp(p_final.log_tau_0)),
        "recovered_beta": float(np.exp(p_final.log_beta)),
    }
    print(f"[train_fullscale] quality: {quality}", flush=True)

    if args.gate_n > 0:
        t0 = time.time()
        gate = detection_gate(
            params, learned_trained, learned_true, n=args.gate_n
        )
        t_gate = time.time() - t0
        print(f"[train_fullscale] detection gate in {t_gate:.0f}s: {gate}",
              flush=True)
    else:
        gate, t_gate = None, 0.0

    ds = max(1, args.iters // 100)
    artifact = {
        "backend": backend,
        "num_spectra": args.num_spectra,
        "rest_grid_pixels": int(train.rest_wavelengths.shape[0]),
        "rank_k": int(params.k),
        "num_iterations": args.iters,
        "chunks": args.chunks,
        "dtype": "float32 (shifted objective; two-stage reshift)",
        "shift_schedule": {
            "stage_a_iters": int(stage_a),
            "stage_b_iters": int(stage_b),
            "shift_a_per_spectrum": round(shift0, 6),
            "shift_b_per_spectrum": round(shift1, 6) if stage_b > 0 else None,
        },
        "wall_s": {
            "generate": round(t_gen, 1),
            "prepare": round(t_prep, 1),
            "fit": round(t_fit, 1),
            "detection_gate": round(t_gate, 1),
        },
        "ms_per_iteration": round(t_fit / args.iters * 1e3, 2),
        "loss_first": float(values[0]),
        "loss_last": float(values[-1]),
        "loss_trajectory_downsampled": {
            "stride": ds,
            "values": [float(v) for v in values[::ds]],
        },
        "model_quality_vs_generating": quality,
        "detection_gate_with_trained_model": gate,
        "reference": "learn_qso_model_meanflux.m:161-184 (minFunc L-BFGS, "
                     "2000 iterations); gate tolerances from "
                     "tests/test_selection.py:437-452",
    }
    with open(args.output, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"[train_fullscale] wrote {args.output}", flush=True)


if __name__ == "__main__":
    main()
