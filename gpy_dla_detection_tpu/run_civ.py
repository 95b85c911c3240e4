"""CLI driver: CIV doublet detection.

Runs the QMC evidence (which the reference never implemented;
reference: civ_gp.py:248-250) and optionally MCMC parameter refinement
for each spectrum.

Usage:
    python -m gpy_dla_detection_tpu.run_civ \
        --qso_list spec-*.fits --z_qso_list 2.1 ... \
        --learned-file learned_model-C13_full.mat
"""

from __future__ import annotations

import argparse


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
    parser.add_argument("--output", default="processed_civ.h5")
    parser.add_argument("--num-samples", type=int, default=10000)
    parser.add_argument("--mcmc-steps", type=int, default=0)
    args = parser.parse_args(argv)

    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax
    import numpy as np

    from .data.fits import spec_reader

    read_spec = spec_reader(args.release)
    from .data.spectrum import preprocess
    from .models.civ import (
        generate_civ_samples,
    )
    from .models.learned import build_spectrum_model
    from .params import CIVParameters

    params = CIVParameters(num_civ_samples=args.num_samples)

    if args.learned_file:
        from .data.loaders import load_learned_model

        learned = load_learned_model(args.learned_file)
    else:
        from .data.synthetic import synthetic_learned_model

        print("[warn] no --learned-file given; using a synthetic CIV-window model")
        learned = synthetic_learned_model(params)

    from .models.civ import civ_inference_many
    from .utils.prefetch import prefetch_map

    samples = generate_civ_samples(params)

    def load(pair):
        fname, z_qso = pair
        wl, flux, nv, pm = read_spec(fname)
        return preprocess(wl, flux, nv, pm, z_qso, params)

    # FITS reads prefetch on a worker thread and stream straight into
    # the evidence pipeline (models/civ.py); spectra are retained only
    # when the MCMC refinement pass needs them afterwards
    pairs = list(zip(args.qso_list, args.z_qso_list))
    specs = []  # filled only under --mcmc-steps

    def spec_stream():
        for spec in prefetch_map(load, pairs):
            if args.mcmc_steps:
                specs.append(spec)
            yield spec

    results = civ_inference_many(
        learned.astype(np.float64), spec_stream(), samples, params
    )
    p_civs = [r[0] for r in results]
    evidences = [(r[1], r[2]) for r in results]
    for fname, p_civ in zip(args.qso_list, p_civs):
        print(f"{fname}: P(CIV|D) = {p_civ:.4f}")

    if args.mcmc_steps:
        from .models.absorber_mcmc import run_civ_mcmc

        for fname, spec in zip(args.qso_list, specs):
            model = build_spectrum_model(learned.astype(np.float64), spec, params)
            model = model._replace(omega2=np.zeros_like(np.asarray(model.v)))
            chain, lps, acc = run_civ_mcmc(
                model, params, jax.random.PRNGKey(0), nsamples=args.mcmc_steps
            )
            tail = np.asarray(chain[-args.mcmc_steps // 4 :]).reshape(-1, 3)
            print(
                f"  {fname} MCMC: z = {np.median(tail[:, 0]):.4f}, "
                f"logN = {np.median(tail[:, 1]):.3f}, "
                f"sigma = {np.median(tail[:, 2]):.3g}"
            )

    import h5py

    with h5py.File(args.output, "w") as f:
        f.create_dataset("p_civs", data=np.asarray(p_civs))
        f.create_dataset("log_evidences", data=np.asarray(evidences))
        f.create_dataset(
            "qso_list", data=np.asarray(args.qso_list, h5py.string_dtype())
        )
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
