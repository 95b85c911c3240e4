"""Low-rank MVN log density vs scipy and the reference implementation."""

import numpy as np
import pytest
from scipy.stats import multivariate_normal

from gpy_dla_detection_tpu.ops.logmvn import (
    batched_log_mvnpdf,
    log_mvnpdf_iid,
    log_mvnpdf_low_rank,
    pair_basis,
)

from .reference_oracle import import_reference


def _problem(n=300, k=8, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=n)
    mu = rng.normal(size=n)
    M = rng.normal(size=(n, k)) / np.sqrt(k)
    d = rng.uniform(0.5, 2.0, size=n)
    return y, mu, M, d


def test_log_mvnpdf_vs_scipy():
    y, mu, M, d = _problem()
    cov = M @ M.T + np.diag(d)
    ref = multivariate_normal(mean=mu, cov=cov).logpdf(y)
    got = float(log_mvnpdf_low_rank(y, mu, M, d))
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_log_mvnpdf_vs_reference():
    import_reference()
    from gpy_dla_detection.null_gp import NullGP

    y, mu, M, d = _problem(seed=1)
    ref = float(NullGP.log_mvnpdf_low_rank(y, mu, M, d))
    got = float(log_mvnpdf_low_rank(y, mu, M, d))
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_log_mvnpdf_masked_equals_dense_subset():
    y, mu, M, d = _problem(seed=2)
    mask = np.ones(y.shape, dtype=bool)
    mask[::7] = False
    got = float(log_mvnpdf_low_rank(y, mu, M, d, mask))
    ref = float(
        log_mvnpdf_low_rank(y[mask], mu[mask], M[mask], d[mask])
    )
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_log_mvnpdf_iid_vs_scipy():
    y, mu, _, d = _problem(seed=3)
    ref = multivariate_normal(mean=mu, cov=np.diag(d)).logpdf(y)
    got = float(log_mvnpdf_iid(y, mu, d))
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_batched_log_mvnpdf_matches_single():
    rng = np.random.default_rng(4)
    n, k, S = 257, 6, 5
    y = rng.normal(size=n)
    mu = rng.uniform(0.5, 1.5, size=n)
    M = rng.normal(size=(n, k)) / np.sqrt(k)
    omega2 = rng.uniform(0.05, 0.2, size=n)
    v = rng.uniform(0.2, 0.5, size=n)
    mask = rng.uniform(size=n) > 0.1
    absorption = rng.uniform(0.3, 1.0, size=(S, n))

    got = np.asarray(
        batched_log_mvnpdf(y, mu, M, omega2, v, mask, absorption, pair_basis(M))
    )
    for s in range(S):
        a = absorption[s]
        ref = float(
            log_mvnpdf_low_rank(
                y, mu * a, M * a[:, None], omega2 * a * a + v, mask
            )
        )
        np.testing.assert_allclose(got[s], ref, rtol=1e-9)


@pytest.mark.parametrize("store", ["i16", "i16p"])
def test_batched_log_mvnpdf_decodes_profile_store(store):
    """Fixed-point profile storage (ops/kernel_config.ABS_STORES) is
    decoded on entry: the likelihood of the encoded profiles equals the
    likelihood of the decoded f32 profiles exactly, and stays within the
    1.5e-5 quantization of the exact profiles."""
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.ops.kernel_config import ABS_STORES
    from gpy_dla_detection_tpu.ops.voigt import (
        decode_profile_store,
        encode_profile_store,
    )

    rng = np.random.default_rng(3)
    N, k, S = 512, 4, 72
    M = (rng.normal(size=(N, k)) / np.sqrt(k) * 0.1).astype(np.float32)
    y = (1 + 0.1 * rng.normal(size=N)).astype(np.float32)
    mu = np.ones(N, np.float32)
    omega2 = rng.uniform(0.01, 0.05, N).astype(np.float32)
    v = rng.uniform(0.02, 0.1, N).astype(np.float32)
    mask = rng.uniform(size=N) > 0.1
    absorption = jnp.asarray(np.exp(-rng.random((S, N))).astype(np.float32))
    args = [jnp.asarray(x) for x in (y, mu, M, omega2, v, mask)]

    codes = encode_profile_store(absorption, ABS_STORES[store])
    assert codes.dtype == ABS_STORES[store]
    decoded = decode_profile_store(codes, jnp.float32)
    # half a code step, plus f32 rounding of the decode
    assert np.abs(np.asarray(decoded) - np.asarray(absorption)).max() < 0.51 / 32767
    got = np.asarray(batched_log_mvnpdf(*args, codes))
    np.testing.assert_array_equal(got, np.asarray(batched_log_mvnpdf(*args, decoded)))
    exact = np.asarray(batched_log_mvnpdf(*args, absorption))
    np.testing.assert_allclose(got, exact, atol=5e-3 * np.mean(np.abs(exact)))


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    def subs(value):
        if isinstance(value, ClosedJaxpr):
            yield value.jaxpr
        elif isinstance(value, Jaxpr):
            yield value
        elif isinstance(value, (tuple, list)):
            for v in value:
                yield from subs(v)

    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for value in eqn.params.values():
            for sub in subs(value):
                out.extend(_dot_precisions(sub))
    return out


def _precision_cases():
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.models import training as T

    rng = np.random.default_rng(0)
    N, k, S, Q = 64, 5, 8, 3
    f = lambda *shape: jnp.asarray(rng.uniform(0.5, 1.5, shape), jnp.float32)
    M = f(N, k)
    mask = jnp.ones(N, bool)
    p = T.TrainingParams(
        M=M, log_omega=f(N), log_c_0=f(), log_tau_0=f(), log_beta=f()
    )
    lya = f(Q, N) + 2.0
    return {
        "log_mvnpdf_low_rank": (
            log_mvnpdf_low_rank, (f(N), f(N), M, f(N), mask)
        ),
        "batched_log_mvnpdf": (
            batched_log_mvnpdf, (f(N), f(N), M, f(N), f(N), mask, f(S, N))
        ),
        "spectrum_loss": (
            lambda *a: T.spectrum_loss(*a, num_forest_lines=3),
            (f(N), lya[0], f(N), mask, f() + 3.0, p),
        ),
        "batched_spectrum_losses": (
            lambda *a: T.batched_spectrum_losses(*a, num_forest_lines=3),
            (p, f(Q, N), lya, f(Q, N), jnp.ones((Q, N), bool), f(Q) + 3.0),
        ),
    }


@pytest.mark.parametrize(
    "name",
    [
        "log_mvnpdf_low_rank",
        "batched_log_mvnpdf",
        "spectrum_loss",
        "batched_spectrum_losses",
    ],
)
def test_likelihood_products_pin_highest_precision(name):
    """Every matrix product of the Woodbury log-densities runs at
    Precision.HIGHEST: at default precision a float32 product may run
    in TF32 on a GPU (about three decimal digits), which the evidences
    and the training loss cannot afford."""
    import jax
    from jax.lax import Precision

    fn, args = _precision_cases()[name]
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precisions, f"{name}: no dot_general traced"
    for prec in precisions:
        assert prec is not None, f"{name}: a dot_general has default precision"
        assert all(q == Precision.HIGHEST for q in prec), (name, prec)
