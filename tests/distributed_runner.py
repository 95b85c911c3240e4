"""Subprocess target for the 2-process ``jax.distributed`` test.

Each process joins the multi-host runtime, takes its ``host_shard`` of
the same 4-spectrum synthetic survey, runs the real selection pipeline
on its shard, and writes a ``shard_filename`` catalog — the multi-host
pattern of ``parallel/distributed.py`` (the JAX equivalent of
the reference's SLURM job array + offline shard merge, reference:
slurm/submit_gp_find_lls.sh:7-13, CDDF_analysis/sbatch_reunion.py).

Usage: python distributed_runner.py PORT PROCESS_ID NUM_PROCESSES OUTDIR
"""

import os
import sys


def survey(params):
    """The global synthetic survey — identical in every process."""
    from gpy_dla_detection_tpu.data.spectrum import preprocess
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
    )

    learned = synthetic_learned_model(params)
    specs, z_qsos = [], [2.9, 3.15, 3.3, 2.8]
    for i, z in enumerate(z_qsos):
        wl, fx, nv, pm = synthetic_observation(
            params, learned, z, seed=i, dlas=[(z - 0.3, 21.2)] if i % 2 else None
        )
        specs.append(preprocess(wl, fx, nv, pm, z, params))
    return learned, specs, z_qsos


def run_batches(batch_ids, outfile):
    """Run the selection pipeline over the given global batch indices
    and write the catalog; deterministic given the batch partition."""
    import jax
    import numpy as np

    from gpy_dla_detection_tpu.catalog_io import write_catalog
    from gpy_dla_detection_tpu.data.samples import (
        generate_dla_samples,
        generate_subdla_samples,
    )
    from gpy_dla_detection_tpu.data.synthetic import synthetic_prior_catalog
    from gpy_dla_detection_tpu.parallel.batch import process_batch
    from gpy_dla_detection_tpu.params import Parameters

    params = Parameters(num_dla_samples=40)
    learned, specs, z_qsos = survey(params)
    prior = synthetic_prior_catalog(params)
    dla_samples = generate_dla_samples(params)
    subdla_samples = generate_subdla_samples(params)

    batches = [[0, 1], [2, 3]]
    # keys are GLOBAL (per batch index), so a shard run and the
    # single-process run feed each batch the same PRNG stream
    keys = jax.random.split(jax.random.PRNGKey(0), len(batches))

    results, kept, z_kept = [], [], []
    for b in batch_ids:
        idx = batches[b]
        results.extend(
            process_batch(
                learned,
                [specs[i] for i in idx],
                dla_samples,
                subdla_samples,
                prior,
                params,
                keys[b],
                max_dlas=2,
                dtype=np.float64,
            )
        )
        kept.extend(f"spec-{i:04d}" for i in idx)
        z_kept.extend(z_qsos[i] for i in idx)
    write_catalog(outfile, results, params, 2, z_kept, kept)


def main():
    port, pid, nprocs, outdir = sys.argv[1:5]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_enable_x64", True)

    if int(nprocs) <= 1:
        # single-process reference run in the SAME environment (bit-
        # exactness across different XLA flag sets is not guaranteed)
        run_batches([0, 1], os.path.join(outdir, "single.h5"))
        print("single-process reference written")
        return

    from gpy_dla_detection_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=int(nprocs),
        process_id=int(pid),
    )
    assert jax.process_count() == int(nprocs), jax.process_count()
    assert jax.process_index() == int(pid)
    my_batches = distributed.host_shard([0, 1])
    outfile = distributed.shard_filename(os.path.join(outdir, "processed.h5"))
    run_batches(my_batches, outfile)
    print(f"process {pid}: wrote {outfile} (batches {my_batches})")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
