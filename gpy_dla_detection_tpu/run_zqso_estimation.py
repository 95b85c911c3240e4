"""CLI driver: quasar redshift estimation over a list of spectra.

Twin of the reference's zQSO test path (reference:
tests/test_zestimation.py:22-77, zqso_gp.py:214-250) as a first-class
batch driver.

Usage:
    python -m gpy_dla_detection_tpu.run_zqso_estimation \
        --qso_list spec-*.fits --learned-file learned_zqso_....mat
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
    parser.add_argument("--learned-file", default=None)
    parser.add_argument("--output", default="zqso_estimates.h5")
    parser.add_argument("--z-min", type=float, default=2.14)
    parser.add_argument("--z-max", type=float, default=6.16)
    parser.add_argument("--num-samples", type=int, default=10000)
    args = parser.parse_args(argv)

    import numpy as np

    from .data.fits import spec_reader

    read_spec = spec_reader(args.release)
    from .data.loaders import load_z_learned_model
    from .models.zqso import prepare_z_spectrum
    from .params import ZParameters

    params = ZParameters(num_zqso_samples=args.num_samples)
    if args.learned_file:
        learned = load_z_learned_model(args.learned_file)
    else:
        from .data.synthetic import synthetic_z_learned_model

        print("[warn] no --learned-file given; using a synthetic zQSO model")
        learned = synthetic_z_learned_model()

    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax
    import jax.numpy as jnp

    # commit the learned model to the device once instead of
    # re-transferring numpy inputs on every dispatch

    learned = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(np.asarray(x))), learned
    )

    from .models.zqso import inference_z_qso_many
    from .utils.prefetch import prefetch_map

    def load(fname):
        wl, flux, nv, pm = read_spec(fname)
        return prepare_z_spectrum(wl, flux, nv, pm, params.num_pixels_padded)

    t0 = time.time()
    # FITS reads prefetch on a worker thread and stream straight into
    # the scan pipeline (reads, device compute and host readback all
    # overlap — models/zqso.py inference_z_qso_many)
    results, _ = inference_z_qso_many(
        learned, prefetch_map(load, args.qso_list), params,
        args.z_min, args.z_max,
    )
    z_maps = [z for z, _ in results]
    for i, (fname, z_map) in enumerate(zip(args.qso_list, z_maps)):
        print(f"[{i + 1}/{len(args.qso_list)}] {fname}: z_map = {z_map:.4f}")
    print(f"{len(z_maps) / (time.time() - t0):.2f} spectra/sec")

    import h5py

    with h5py.File(args.output, "w") as f:
        f.create_dataset("z_map", data=np.asarray(z_maps))
        f.create_dataset(
            "qso_list", data=np.asarray(args.qso_list, h5py.string_dtype())
        )
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
