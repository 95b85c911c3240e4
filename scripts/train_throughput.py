"""Training-head throughput: ms per L-BFGS iteration at reference scale.

The reference trains with MATLAB minFunc L-BFGS over a serial
per-spectrum objective loop (reference: learn_qso_model_meanflux.m:
161-162, objective_lyseries.m:42) — ~2,000 iterations over the full
DR12Q training set.  This measures the JAX rebuild's per-iteration
cost for (a) the batched objective (one (Q, R) x (R, k^2) matmul +
unrolled Cholesky chain) and (b) the naive vmapped per-spectrum loss
with XLA's batched cholesky/triangular_solve, at the reference's
R=1217, k=20, 31 forest lines.

One fit_lbfgs call is a single dispatch containing the whole scan; it
is timed to ``jax.block_until_ready`` on its result.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gpy_dla_detection_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

from gpy_dla_detection_tpu.models.training import (
    TrainingParams,
    fit_lbfgs,
    spectrum_loss,
    total_objective,
)
from gpy_dla_detection_tpu.params import Parameters

Q = int(os.environ.get("TRAIN_Q", "4096"))
ITERS = int(os.environ.get("TRAIN_ITERS", "20"))


def synth(Q, R, k, rng):
    p0 = TrainingParams(
        M=jnp.asarray(rng.normal(0, 0.3, (R, k)).astype(np.float32)),
        log_omega=jnp.asarray(np.log(rng.uniform(0.1, 0.3, R)).astype(np.float32)),
        log_c_0=jnp.asarray(np.float32(np.log(0.1))),
        log_tau_0=jnp.asarray(np.float32(np.log(0.0023))),
        log_beta=jnp.asarray(np.float32(np.log(3.65))),
    )
    flux = rng.normal(0, 1, (Q, R)).astype(np.float32)
    lya_1pz = np.linspace(3.0, 4.2, R).astype(np.float32)[None].repeat(Q, 0)
    nv = rng.uniform(0.01, 0.3, (Q, R)).astype(np.float32)
    mask = rng.uniform(size=(Q, R)) > 0.2
    zqso = rng.uniform(2.5, 4.5, Q).astype(np.float32)
    args = tuple(
        jax.device_put(jnp.asarray(x))
        for x in (flux * mask, lya_1pz, nv, mask, zqso)
    )
    return p0, args


def time_fit(p0, args, params, iters, objective=None):
    kwargs = {} if objective is None else {"objective": objective}
    jax.block_until_ready(fit_lbfgs(p0, *args, params, iters, **kwargs))
    t0 = time.time()
    p, values = jax.block_until_ready(
        fit_lbfgs(p0, *args, params, iters, **kwargs)
    )
    dt = time.time() - t0
    v = np.asarray(values)
    assert np.isfinite(v).all(), v
    return dt / iters * 1e3, v


def vmapped_objective(p, flux, lya_1pz, nv, mask, zqso, params):
    losses = jax.vmap(
        lambda y, z1, v, m, zq: spectrum_loss(
            y, z1, v, m, zq, p, params.num_forest_lines
        )
    )(flux, lya_1pz, nv, mask, zqso)
    return jnp.sum(losses)


def main():
    params = Parameters()
    R = int(
        round((params.max_lambda - params.min_lambda) / params.dlambda)
    ) + 1
    rng = np.random.default_rng(0)
    p0, args = synth(Q, R, params.k, rng)
    print(f"Q={Q} R={R} k={params.k} iters={ITERS} "
          f"backend={jax.default_backend()}")

    ms_b, v_b = time_fit(p0, args, params, ITERS)
    print(f"batched objective:  {ms_b:8.1f} ms/iteration "
          f"({Q / (ms_b / 1e3):,.0f} spectrum-losses/sec)")

    ms_v, v_v = time_fit(p0, args, params, ITERS, objective=vmapped_objective)
    print(f"vmapped objective:  {ms_v:8.1f} ms/iteration")
    print(f"speedup: {ms_v / ms_b:.1f}x; final losses "
          f"batched={v_b[-1]:.3f} vmapped={v_v[-1]:.3f}")


if __name__ == "__main__":
    main()
