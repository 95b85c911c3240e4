"""CLI driver: strong-Lya-absorber (LLS) search.

Twin of the reference's self-contained LLS finder driver
(reference: examples/gp_find_lls.py:825-1125, launched per spectrum by
slurm/submit_gp_find_lls.sh): null-vs-k-absorber model selection using
the Lyman-limit-break profile and the BOSS mean-flux parameters.

Usage:
    python -m gpy_dla_detection_tpu.run_find_lls \
        --qso_list spec-*.fits --z_qso_list 3.1 ... \
        [--learned-file learned.mat] [--max-lya 4]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--qso_list", nargs="+", required=True)
    parser.add_argument(
        "--release",
        choices=["dr12q", "dr14q"],
        default="dr12q",
        help="data release the spectra come from (selects the reader; "
        "reference: read_spec.py:22,74)",
    )
    parser.add_argument("--z_qso_list", nargs="+", type=float, required=True)
    parser.add_argument("--learned-file", default=None)
    parser.add_argument("--output", default="processed_lls.h5")
    parser.add_argument("--max-lya", type=int, default=4)
    parser.add_argument("--num-samples", type=int, default=10000)
    parser.add_argument("--min-log-nhi", type=float, default=17.2)
    parser.add_argument("--max-log-nhi", type=float, default=23.0)
    parser.add_argument("--min-lambda", type=float, default=850.0)
    parser.add_argument(
        "--boss-meanflux",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="apply the BOSS DR12 mean-flux lift to the learned model "
        "(default on; --no-boss-meanflux disables it — the old "
        "store_true/default=True combination made the flag dead)",
    )
    parser.add_argument(
        "--prior",
        choices=["garnett", "uniform"],
        default="garnett",
        help="logNHI sample prior: data-driven Garnett fit (reference "
        "default) or flat",
    )
    parser.add_argument("--catalog-file", default=None, help="catalog.mat for "
                        "data-driven model priors")
    parser.add_argument("--los-catalog", default=None)
    parser.add_argument("--dla-catalog", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import h5py
    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax
    import numpy as np

    from .data.fits import spec_reader

    read_spec = spec_reader(args.release)
    from .data.spectrum import preprocess
    from .data.synthetic import synthetic_learned_model
    from .models.lls import (
        generate_lya_samples,
        lls_model_posteriors,
        with_boss_meanflux,
    )
    from .params import Parameters

    # a bluer model window so Lyman-limit breaks are inside it
    params = Parameters(
        num_dla_samples=args.num_samples,
        min_lambda=args.min_lambda,
        num_pixels_padded=1664 if args.min_lambda < 900 else 1280,
    )

    if args.learned_file:
        from .data.loaders import load_learned_model

        learned = load_learned_model(args.learned_file)
    else:
        print("[warn] no --learned-file; using a synthetic learned model")
        learned = synthetic_learned_model(params)
    if args.boss_meanflux:
        learned = with_boss_meanflux(learned)

    samples = generate_lya_samples(
        args.num_samples, args.min_log_nhi, args.max_log_nhi, prior=args.prior
    )

    prior_catalog = None
    if args.catalog_file:
        from .data.catalog import PriorCatalog

        prior_catalog = PriorCatalog.from_mat(
            params, args.catalog_file, args.los_catalog, args.dla_catalog
        )

    from .models.lls import lls_inference_many
    from .utils.prefetch import prefetch_map

    def load(pair):
        fname, z_qso = pair
        wl, flux, nv, pm = read_spec(fname)
        return preprocess(wl, flux, nv, pm, z_qso, params)

    key = jax.random.PRNGKey(args.seed)
    rows = []
    t0 = time.time()
    # FITS reads prefetch on a worker thread and stream straight into
    # the compiled per-spectrum pipeline (models/lls.py); the search
    # windows are captured as spectra stream past
    z_windows = []

    def spec_stream():
        for spec in prefetch_map(
            load, list(zip(args.qso_list, args.z_qso_list))
        ):
            z_windows.append(
                (float(spec.min_z_dla), float(spec.max_z_dla))
            )
            yield spec

    outs = lls_inference_many(
        learned, spec_stream(), samples, key, args.max_lya, params
    )
    for i, ((fname, z_qso), (min_z, max_z), (null_ev, result)) in enumerate(
        zip(zip(args.qso_list, args.z_qso_list), z_windows, outs)
    ):
        if prior_catalog is not None:
            m, n = prior_catalog.less_ind(z_qso)
            post = lls_model_posteriors(
                null_ev, result.log_evidences, m, n
            )
        else:
            post = lls_model_posteriors(null_ev, result.log_evidences)
        rows.append(
            dict(
                null_ev=null_ev,
                lls_evs=result.log_evidences,
                posteriors=post,
                map_z=result.map_z_dlas,
                map_lognhi=result.map_log_nhis,
                min_z=min_z,
                max_z=max_z,
            )
        )
        p_lls = 1.0 - post[0]
        print(
            f"[{i + 1}/{len(args.qso_list)}] {fname}: P(LLS|D)={p_lls:.4f} "
            f"MAP z={rows[-1]['map_z'][0, 0]:.4f} "
            f"logNHI={rows[-1]['map_lognhi'][0, 0]:.3f} "
            f"({(i + 1) / (time.time() - t0):.2f} spectra/s)"
        )

    with h5py.File(args.output, "w") as f:
        f.create_dataset("min_z_lyas", data=np.array([r["min_z"] for r in rows]))
        f.create_dataset("max_z_lyas", data=np.array([r["max_z"] for r in rows]))
        f.create_dataset(
            "log_likelihoods_no_lya", data=np.array([r["null_ev"] for r in rows])
        )
        f.create_dataset(
            "log_likelihoods_lya", data=np.stack([r["lls_evs"] for r in rows])
        )
        f.create_dataset(
            "model_posteriors", data=np.stack([r["posteriors"] for r in rows])
        )
        f.create_dataset("MAP_z_lyas", data=np.stack([r["map_z"] for r in rows]))
        f.create_dataset(
            "MAP_log_nhis", data=np.stack([r["map_lognhi"] for r in rows])
        )
        f.create_dataset("z_qsos", data=np.asarray(args.z_qso_list))
        f.create_dataset(
            "qso_list", data=np.asarray(args.qso_list, h5py.string_dtype())
        )
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
