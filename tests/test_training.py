"""GP training: loss correctness, gradients, and end-to-end recovery."""

import numpy as np
import jax
import jax.numpy as jnp
from scipy.stats import multivariate_normal

from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu.models.training import (
    TrainingParams,
    initialize,
    prepare_training_set,
    spectrum_loss,
    total_objective,
    train_model,
)
from gpy_dla_detection_tpu.params import Parameters


def _tiny_problem(seed=0, R=40, k=4):
    rng = np.random.default_rng(seed)
    p = TrainingParams(
        M=jnp.asarray(rng.normal(size=(R, k)) * 0.3),
        log_omega=jnp.asarray(np.log(rng.uniform(0.05, 0.3, R))),
        log_c_0=jnp.asarray(np.log(0.1)),
        log_tau_0=jnp.asarray(np.log(0.0023)),
        log_beta=jnp.asarray(np.log(3.65)),
    )
    y = rng.normal(size=R)
    lya_1pz = np.linspace(3.0, 4.0, R)
    v = rng.uniform(0.01, 0.1, R)
    mask = rng.uniform(size=R) > 0.15
    zqso = np.float64(3.1)
    return p, y, lya_1pz, v, mask, zqso


def test_spectrum_loss_matches_dense_logpdf():
    """The masked Woodbury loss equals the dense MVN logpdf with the
    absorption-noise covariance built explicitly
    (reference: spectrum_loss_lyseries.m:14-69)."""
    from gpy_dla_detection_tpu.constants import (
        LYMAN_OSCILLATOR_STRENGTHS,
        LYMAN_WAVELENGTHS_A,
    )

    p, y, lya_1pz, v, mask, zqso = _tiny_problem()
    L = 31
    got = float(
        spectrum_loss(
            jnp.where(mask, y, 0.0), lya_1pz, v, mask, zqso, p, L
        )
    )

    # dense covariance on unmasked pixels only
    tau = np.exp(float(p.log_tau_0)) * lya_1pz ** np.exp(float(p.log_beta))
    for i in range(1, L):
        one_pz = LYMAN_WAVELENGTHS_A[0] * lya_1pz / LYMAN_WAVELENGTHS_A[i]
        ind = one_pz - 1.0 <= zqso - 1.0
        scale = (
            np.exp(float(p.log_tau_0))
            * LYMAN_WAVELENGTHS_A[i]
            * LYMAN_OSCILLATOR_STRENGTHS[i]
            / (LYMAN_WAVELENGTHS_A[0] * LYMAN_OSCILLATOR_STRENGTHS[0])
        )
        tau = tau + np.where(ind, scale * (one_pz * ind) ** np.exp(float(p.log_beta)), 0.0)
    scaling = 1.0 - np.exp(-tau) + np.exp(float(p.log_c_0))
    omega2 = np.exp(2.0 * np.asarray(p.log_omega))
    d = v + omega2 * scaling**2

    M = np.asarray(p.M)[mask]
    cov = M @ M.T + np.diag(d[mask])
    ref = -multivariate_normal(mean=np.zeros(mask.sum()), cov=cov).logpdf(y[mask])
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_batched_losses_match_vmapped_spectrum_loss():
    """The batched objective path (one matmul against the outer-product
    basis + unrolled Cholesky chain) equals vmapping the per-spectrum
    reference loss, in value and in gradient."""
    from gpy_dla_detection_tpu.models.training import batched_spectrum_losses

    Q = 5
    ys, zs1, vs, ms, zqs = [], [], [], [], []
    for q in range(Q):
        p, y, lya_1pz, v, mask, zqso = _tiny_problem(seed=10 + q)
        ys.append(np.where(mask, y, 0.0)); zs1.append(lya_1pz)
        vs.append(v); ms.append(mask); zqs.append(zqso + 0.1 * q)
    args = (
        jnp.asarray(np.stack(ys)), jnp.asarray(np.stack(zs1)),
        jnp.asarray(np.stack(vs)), jnp.asarray(np.stack(ms)),
        jnp.asarray(np.asarray(zqs)),
    )
    L = 31
    got = batched_spectrum_losses(p, *args, L)
    ref = jax.vmap(
        lambda y, z1, v, m, zq: spectrum_loss(y, z1, v, m, zq, p, L)
    )(*args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-10)

    g_got = jax.grad(lambda pp: jnp.sum(batched_spectrum_losses(pp, *args, L)))(p)
    g_ref = jax.grad(
        lambda pp: jnp.sum(
            jax.vmap(
                lambda y, z1, v, m, zq: spectrum_loss(y, z1, v, m, zq, pp, L)
            )(*args)
        )
    )(p)
    for name in TrainingParams._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(g_got, name)), np.asarray(getattr(g_ref, name)),
            rtol=1e-8, atol=1e-10,
        )


def test_gradients_match_finite_differences():
    """jax.grad of the objective vs central finite differences — the
    analog of validating the reference's five hand-derived gradient
    blocks (spectrum_loss_lyseries.m:71-91)."""
    p, y, lya_1pz, v, mask, zqso = _tiny_problem(seed=1)
    args = (
        jnp.where(mask, y, 0.0)[None],
        jnp.asarray(lya_1pz)[None],
        jnp.asarray(v)[None],
        jnp.asarray(mask)[None],
        jnp.asarray([zqso]),
    )
    params = Parameters()

    loss = lambda pp: total_objective(pp, *args, params)
    grads = jax.grad(loss)(p)

    eps = 1e-6
    for name in ["log_c_0", "log_tau_0", "log_beta"]:
        up = p._replace(**{name: getattr(p, name) + eps})
        dn = p._replace(**{name: getattr(p, name) - eps})
        fd = (float(loss(up)) - float(loss(dn))) / (2 * eps)
        np.testing.assert_allclose(float(getattr(grads, name)), fd, rtol=1e-4)

    # spot-check a few M entries and log_omega entries
    rng = np.random.default_rng(0)
    for _ in range(3):
        i, j = rng.integers(0, p.M.shape[0]), rng.integers(0, p.M.shape[1])
        dM = jnp.zeros_like(p.M).at[i, j].set(eps)
        fd = (float(loss(p._replace(M=p.M + dM))) - float(loss(p._replace(M=p.M - dM)))) / (2 * eps)
        np.testing.assert_allclose(float(grads.M[i, j]), fd, rtol=1e-3, atol=1e-7)


def test_train_model_recovers_synthetic_gp():
    """Train on spectra drawn from a known GP; the learned mean must be
    close to the truth and training must improve the objective."""
    params = Parameters(k=6)
    truth = synthetic_learned_model(params, seed=3)

    wl_list, fx_list, nv_list, pm_list, zs = [], [], [], [], []
    rng = np.random.default_rng(0)
    for i in range(12):
        z = float(rng.uniform(2.5, 3.6))
        wl, fx, nv, pm = synthetic_observation(
            params, truth, z, seed=100 + i, noise_level=0.05
        )
        # normalize like the real pipeline would (median in the red window)
        rest = wl / (1 + z)
        norm = np.nanmedian(fx[(rest >= 1310) & (rest <= 1325)])
        wl_list.append(wl)
        fx_list.append(fx / norm)
        nv_list.append(nv / norm**2)
        pm_list.append(pm)
        zs.append(z)

    train = prepare_training_set(params, wl_list, fx_list, nv_list, pm_list, zs)
    assert train.mask.sum() > 1000

    learned, losses = train_model(params, train, num_iterations=30)

    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])

    # learned mean close to the (normalized) true mean over well-covered pixels
    covered = train.mask.sum(0) >= 8
    truth_mu = truth.mu / np.mean(truth.mu)
    got_mu = learned.mu / np.mean(learned.mu[covered])
    rel = np.abs(got_mu[covered] - truth_mu[covered]) / np.abs(truth_mu[covered])
    assert np.median(rel) < 0.15, np.median(rel)


def test_training_checkpoint_resume(tmp_path):
    """Chunked training with checkpointing resumes mid-run and matches
    the parameters at the checkpoint step count."""
    params = Parameters(k=4)
    truth = synthetic_learned_model(params, seed=5)
    rng = np.random.default_rng(1)
    wl_l, fx_l, nv_l, pm_l, zs = [], [], [], [], []
    for i in range(6):
        z = float(rng.uniform(2.6, 3.4))
        wl, fx, nv, pm = synthetic_observation(params, truth, z, seed=300 + i, noise_level=0.05)
        wl_l.append(wl); fx_l.append(fx); nv_l.append(nv); pm_l.append(pm); zs.append(z)
    train = prepare_training_set(params, wl_l, fx_l, nv_l, pm_l, zs)

    ckpt = str(tmp_path / "train.npz")
    learned1, losses1 = train_model(
        params, train, num_iterations=10, checkpoint_path=ckpt, checkpoint_every=5
    )
    assert losses1.shape[0] == 10

    # resume: checkpoint says step 10 -> extending to 15 runs 5 more
    learned2, losses2 = train_model(
        params, train, num_iterations=15, checkpoint_path=ckpt, checkpoint_every=5
    )
    assert losses2.shape[0] == 5
    assert np.isfinite(losses2).all()


def test_host_mean_flux_twin_matches_jnp_op():
    """The host-numpy mean-flux lift used by prepare_training_set must
    match the jnp op build_spectrum_model applies at inference time —
    the twin exists so the one-time host prep never pays a device round
    trip per spectrum (Q = 65k at reference scale)."""
    from gpy_dla_detection_tpu.models.training import _mean_flux_suppression_np
    from gpy_dla_detection_tpu.ops.optical_depth import mean_flux_suppression

    rng = np.random.default_rng(0)
    obs_wl = np.sort(rng.uniform(3600.0, 5800.0, size=512))
    for z, beta, tau_0 in [(3.1, 3.182, 0.00554), (2.4, 3.65, 0.0023)]:
        want = np.asarray(
            mean_flux_suppression(jnp.asarray(obs_wl), beta, tau_0, z, 31),
            np.float64,
        )
        got = _mean_flux_suppression_np(obs_wl, beta, tau_0, z, 31)
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_fit_lbfgs_stepwise_matches_scan_variant():
    """The step-granular fitter (one jitted step in a Python loop —
    what the reference-scale run uses, scripts/train_fullscale.py) must
    walk the same trajectory as the whole-scan ``fit_lbfgs``."""
    from gpy_dla_detection_tpu.models.training import (
        fit_lbfgs,
        fit_lbfgs_stepwise,
    )

    params = Parameters(k=4)
    truth = synthetic_learned_model(params, seed=5)
    wl_list, fx_list, nv_list, pm_list, zs = [], [], [], [], []
    rng = np.random.default_rng(2)
    for i in range(6):
        z = float(rng.uniform(2.5, 3.4))
        wl, fx, nv, pm = synthetic_observation(
            params, truth, z, seed=400 + i, noise_level=0.05
        )
        wl_list.append(wl)
        fx_list.append(fx)
        nv_list.append(nv)
        pm_list.append(pm)
        zs.append(z)
    train = prepare_training_set(params, wl_list, fx_list, nv_list, pm_list, zs)
    mu, p0 = initialize(params, train)
    flux_centered = jnp.asarray(np.where(train.mask, train.flux - mu, 0.0))
    fit_args = (
        flux_centered,
        jnp.asarray(train.lya_1pz),
        jnp.asarray(train.noise_variance),
        jnp.asarray(train.mask),
        jnp.asarray(train.zqso_1pz),
    )

    calls = []
    p_sw, v_sw = fit_lbfgs_stepwise(
        p0, *fit_args, params, 8,
        callback=lambda i, v: calls.append((i, v)) or False,
        callback_every=4,
    )
    p_sc, v_sc = fit_lbfgs(p0, *fit_args, params, 8)

    np.testing.assert_allclose(v_sw, np.asarray(v_sc), rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(p_sw.M), np.asarray(p_sc.M), rtol=0, atol=1e-10
    )
    assert [i for i, _ in calls] == [3, 7]
    assert v_sw[-1] < v_sw[0]
