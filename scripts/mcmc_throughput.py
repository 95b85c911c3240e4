"""MCMC-head throughput: full reference-scale ensemble runs on device.

The reference's ``DLAGP.run_mcmc`` is emcee with a serial Python
posterior — every step evaluates nwalkers Voigt + Woodbury likelihoods
one at a time (reference: dla_gp.py:227-309, civ_gp.py:77-156).  The
batched sampler advances the whole ensemble per step under vmap with the
step loop as one on-device ``lax.scan`` (models/mcmc.py), so an entire
32 x 5,000 chain is a single dispatch.

Each timed run uses a different PRNG key and spectrum and ends in
``jax.block_until_ready``.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gpy_dla_detection_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

from gpy_dla_detection_tpu.data.spectrum import preprocess
from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu.models.absorber_mcmc import (
    run_civ_mcmc,
    run_dla_mcmc,
)
from gpy_dla_detection_tpu.models.learned import build_spectrum_model
from gpy_dla_detection_tpu.params import CIVParameters, Parameters

REPS = int(os.environ.get("MCMC_REPS", "4"))


def build_models(params, n, z0=3.05, dla=(2.82, 21.0)):
    learned = synthetic_learned_model(params)
    models = []
    for i in range(n):
        wl, fx, nv, pm = synthetic_observation(
            params, learned, z0, seed=20 + i, dlas=[dla], noise_level=0.05
        )
        spec = preprocess(wl, fx, nv, pm, z0, params)
        models.append(build_spectrum_model(learned.astype(np.float32), spec, params))
    return models


def time_chain(label, runs, nwalkers, nsamples):
    jax.block_until_ready(runs[0]())  # compile
    t0 = time.time()
    outs = [jax.block_until_ready(run()) for run in runs]
    dt = (time.time() - t0) / len(runs)
    total = nwalkers * nsamples
    print(
        f"{label:<10} {dt:6.2f} s/chain ({nwalkers} walkers x {nsamples} "
        f"steps; {total / dt:,.0f} posterior evals/sec; "
        f"acceptance {float(outs[-1][2]):.2f})",
        flush=True,
    )


def main():
    print(f"backend={jax.default_backend()} reps={REPS}")

    params = Parameters()
    models = build_models(params, REPS)
    nw, ns = 32, 5000
    runs = [
        (lambda m=m, i=i: run_dla_mcmc(
            m, params, jax.random.PRNGKey(i), k_dlas=1, nwalkers=nw,
            nsamples=ns,
        ))
        for i, m in enumerate(models)
    ]
    time_chain("dla 1x", runs, nw, ns)

    cparams = CIVParameters()
    cmodels = build_models(cparams, REPS, z0=2.2, dla=(2.1, 20.5))
    cw, cs = 40, 5000
    cruns = [
        (lambda m=m, i=i: run_civ_mcmc(
            m, cparams, jax.random.PRNGKey(100 + i), k_civ=1, nwalkers=cw,
            nsamples=cs,
        ))
        for i, m in enumerate(cmodels)
    ]
    time_chain("civ", cruns, cw, cs)


if __name__ == "__main__":
    main()
