"""Benchmark: full Bayesian model selection throughput on one chip.

Reference workload per spectrum (BASELINE.md): 10,000 QMC samples x
(4 DLA levels + 1 subDLA) + null evidence, rank-20 GP over ~1,250
pixels — the reference Python takes ~4 minutes per spectrum on one CPU
core (reference: run_bayes_select.py:233).

Prints one JSON line: spectra/sec on the first device, with the
device named, and vs_baseline = speedup over the reference's ~1/240
spectra/sec.
"""

import json
import time

import numpy as np

BASELINE_SPECTRA_PER_SEC = 1.0 / 240.0


def main():
    from gpy_dla_detection_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.data.samples import (
        generate_dla_samples,
        generate_subdla_samples,
    )
    from gpy_dla_detection_tpu.data.spectrum import astype, stack
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_spectrum,
    )
    from gpy_dla_detection_tpu.parallel.batch import (
        batch_evidences,
        device_put_inputs,
    )
    from gpy_dla_detection_tpu.params import Parameters

    params = Parameters()  # full scale: 10k samples, 1280-pixel window
    max_dlas = 4
    batch = 32
    dtype = jnp.float32

    learned = synthetic_learned_model(params)
    spectra = [
        synthetic_spectrum(
            params,
            learned,
            2.8 + 0.08 * i,
            seed=i,
            dlas=[(2.5 + 0.05 * i, 20.5)] if i % 2 else None,
        )
        for i in range(batch)
    ]
    specs = stack(spectra)
    dla_s = generate_dla_samples(params)
    sub_s = generate_subdla_samples(params)
    keys = jax.random.split(jax.random.PRNGKey(0), batch)

    # commit the batch-invariant inputs to the device once
    learned, dla_s, sub_s = device_put_inputs(learned, dla_s, sub_s, dtype)
    specs = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x)), astype(specs, np.float32)
    )
    keys = jax.device_put(keys)

    def run(k):
        return batch_evidences(
            learned,
            specs,
            dla_s,
            sub_s,
            k,
            params,
            max_dlas,
            mesh=None,
            dtype=None,
        )

    # warmup / compile
    out = run(keys)
    jax.block_until_ready(out.dla.log_evidences)
    assert np.isfinite(np.asarray(out.log_evidence_null)).all()

    # steady-state throughput: each pass ends in block_until_ready;
    # the median pass is reported
    passes = 5
    pass_keys = [
        jax.device_put(jax.random.split(jax.random.PRNGKey(1000 + i), batch))
        for i in range(passes)
    ]
    times = []
    for k in pass_keys:
        t0 = time.perf_counter()
        jax.block_until_ready(run(k))
        times.append(time.perf_counter() - t0)
    spectra_per_sec = batch / float(np.median(times))
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "spectra/sec (full Bayes selection: null + subDLA + 4-DLA, 10k QMC samples)",
                "value": round(spectra_per_sec, 3),
                "unit": "spectra/sec/device",
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": 1,
                },
                "vs_baseline": round(spectra_per_sec / BASELINE_SPECTRA_PER_SEC, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
