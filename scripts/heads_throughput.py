"""Throughput of the zQSO / CIV / LLS heads (amortized wall clock).

Each head processes DIFFERENT synthetic spectra through its pipelined
many-path; ms/spectrum = total wall time / count with compilation
excluded by a warm-up pass (wall clock around full materialization
with different inputs per call).

Usage: python scripts/heads_throughput.py [--count 64] [--head all]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gpy_dla_detection_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import numpy as np


def time_head(label, run, warm):
    warm()
    t0 = time.time()
    n = run()
    dt = time.time() - t0
    print(
        f"{label:<6} {1e3 * dt / n:8.1f} ms/spectrum  "
        f"{n / dt:6.1f} spectra/sec  ({n} spectra)",
        flush=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=64)
    ap.add_argument(
        "--head", default="all", choices=["all", "lls", "civ", "zqso"]
    )
    args = ap.parse_args()

    import jax

    from gpy_dla_detection_tpu.data.spectrum import preprocess
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
        synthetic_z_learned_model,
    )
    from gpy_dla_detection_tpu.params import CIVParameters, Parameters

    if args.head in ("all", "lls"):
        from gpy_dla_detection_tpu.models.lls import (
            generate_lya_samples,
            lls_inference_many,
        )

        params = Parameters(min_lambda=911.75)
        learned = synthetic_learned_model(params)
        samples = generate_lya_samples(params.num_dla_samples)

        def lls_specs(n, seed0=0):
            for i in range(n):
                z = 2.9 + 0.3 * (i % 5) / 5.0
                wl, fx, nv, pm = synthetic_observation(
                    params, learned, z, seed=seed0 + i
                )
                yield preprocess(wl, fx, nv, pm, z, params)

        key = jax.random.PRNGKey(0)
        time_head(
            "lls",
            lambda: len(
                lls_inference_many(
                    learned, lls_specs(args.count, 1000), samples, key, 2,
                    params,
                )
            ),
            lambda: lls_inference_many(
                learned, lls_specs(8), samples, key, 2, params
            ),
        )

    if args.head in ("all", "civ"):
        from gpy_dla_detection_tpu.models.civ import (
            civ_inference_many,
            generate_civ_samples,
        )

        cparams = CIVParameters()
        clearned = synthetic_learned_model(cparams)
        csamples = generate_civ_samples(cparams)

        def civ_specs(n, seed0=0):
            for i in range(n):
                z = 2.1 + 0.2 * (i % 5) / 5.0
                wl, fx, nv, pm = synthetic_observation(
                    cparams, clearned, z, seed=seed0 + i
                )
                yield preprocess(wl, fx, nv, pm, z, cparams)

        time_head(
            "civ",
            lambda: len(
                civ_inference_many(
                    clearned, civ_specs(args.count, 1000), csamples, cparams
                )
            ),
            lambda: civ_inference_many(
                clearned, civ_specs(16), csamples, cparams
            ),
        )

    if args.head in ("all", "zqso"):
        from gpy_dla_detection_tpu.models.zqso import (
            ZParameters,
            inference_z_qso_many,
            prepare_z_spectrum,
        )

        zlearned = synthetic_z_learned_model()
        zparams = ZParameters()

        def z_specs(n, seed0=0):
            rng = np.random.default_rng(seed0)
            for i in range(n):
                P = 4000
                wl = 3810.0 * 10 ** (1e-4 * np.arange(P))
                fx = 1.0 + 0.05 * rng.standard_normal(P)
                nv = np.full(P, 0.01)
                pm = np.zeros(P, bool)
                yield prepare_z_spectrum(wl, fx, nv, pm)

        time_head(
            "zqso",
            lambda: len(
                inference_z_qso_many(
                    zlearned, z_specs(args.count, 1000), zparams
                )[0]
            ),
            lambda: inference_z_qso_many(zlearned, z_specs(4), zparams),
        )


if __name__ == "__main__":
    main()
