"""Card-only checks: run on a GPU with

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu -p no:xdist

(``chip_smoke.py`` runs them in its own process).  Without a GPU every
test here skips (the ``gpu`` fixture decides at run time)."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _problem(rng, N=1280, k=20, S=2000):
    M = rng.normal(size=(N, k)) / np.sqrt(k)
    return dict(
        y=1 + 0.1 * rng.normal(size=N),
        mu=np.ones(N),
        M=M,
        omega2=rng.uniform(0.01, 0.05, N),
        v=rng.uniform(0.02, 0.1, N),
        mask=rng.uniform(size=N) > 0.05,
        absorption=np.exp(-rng.random((S, N))),
    )


def test_gpu_f32_likelihood_matches_f64(gpu):
    """The batched Woodbury log-density in f32 on the card agrees with
    f64 on the card to f32 rounding (a product that silently ran in TF32
    would miss by ~1e-3 relative)."""
    import jax
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.ops.logmvn import batched_log_mvnpdf

    p = _problem(np.random.default_rng(0))
    names = ("y", "mu", "M", "omega2", "v", "mask", "absorption")

    def run(dtype):
        args = [
            jax.device_put(
                jnp.asarray(p[n], bool if n == "mask" else dtype), gpu
            )
            for n in names
        ]
        return np.asarray(jax.jit(batched_log_mvnpdf)(*args), np.float64)

    got, want = run(jnp.float32), run(jnp.float64)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_gpu_f32_null_evidence_matches_f64(gpu):
    """The single-spectrum low-rank log-density (null evidence, CIV,
    zQSO and MCMC heads) in f32 on the card agrees with f64."""
    import jax
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.ops.logmvn import log_mvnpdf_low_rank

    p = _problem(np.random.default_rng(1))
    d = p["omega2"] + p["v"]

    def run(dtype):
        args = [
            jax.device_put(jnp.asarray(x, dtype), gpu)
            for x in (p["y"], p["mu"], p["M"], d)
        ]
        mask = jax.device_put(jnp.asarray(p["mask"]), gpu)
        return float(jax.jit(log_mvnpdf_low_rank)(*args, mask))

    np.testing.assert_allclose(run(jnp.float32), run(jnp.float64), rtol=2e-5)


def test_gpu_chunked_searchsorted_matches_numpy(gpu):
    """The inverse-CDF count of the importance resampler gives exactly
    numpy's insertion indices on the card.  (Its former one-hot bf16
    matmul row fetch miscounted on XLA:GPU by up to 38 positions.)"""
    import jax

    from gpy_dla_detection_tpu.ops.interp import chunked_searchsorted

    rng = np.random.default_rng(2)
    cdf = np.cumsum(rng.random(10000)).astype(np.float32)
    u = (rng.random(10000) * cdf[-1]).astype(np.float32)
    got = jax.jit(chunked_searchsorted)(
        jax.device_put(cdf, gpu), jax.device_put(u, gpu)
    )
    np.testing.assert_array_equal(
        np.asarray(got), np.searchsorted(cdf, u, side="right")
    )


def test_gpu_windowed_voigt_matches_exact(gpu):
    """The windowed f32 Voigt agrees with the exact blend on the card at
    full width (10,000 absorbers over a 1,280-pixel window)."""
    import jax
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.ops.voigt import voigt_absorption

    rng = np.random.default_rng(3)
    wl = jnp.asarray(3600.0 * 10 ** (1e-4 * np.arange(1280)), jnp.float32)
    z = jnp.asarray(rng.uniform(2.0, 2.9, 10000), jnp.float32)
    nhi = jnp.asarray(10 ** rng.uniform(20.0, 22.5, 10000), jnp.float32)
    wl, z, nhi = (jax.device_put(x, gpu) for x in (wl, z, nhi))
    run = jax.jit(voigt_absorption, static_argnames=("num_lines", "impl"))
    exact = np.asarray(run(wl, nhi, z, num_lines=3, impl="exact"))
    windowed = np.asarray(run(wl, nhi, z, num_lines=3, impl="windowed"))
    # f32 cancellation at the line cores bounds the worst pixel; the
    # bulk agrees to the far-field truncation (~5e-5)
    err = np.abs(exact - windowed)
    assert err.max() < 2e-2, err.max()
    assert np.quantile(err, 0.99) < 5e-5, np.quantile(err, 0.99)
