"""CLI driver: batched Bayesian DLA detection over a list of spectra.

Twin of the reference driver (reference: run_bayes_select.py:32-343):
loads (or synthesizes) the learned model, prior catalog and QMC
samples, preprocesses the given spectra, runs the batched selection
sharded over every local device, and writes the processed catalog
(HDF5, or numpy .npz when --output ends in .npz).

Usage:
    python -m gpy_dla_detection_tpu.run_bayes_select \
        --qso_list spec-*.fits --z_qso_list 2.6 3.1 ... \
        [--max_dlas 4] [--learned-file learned.mat ...]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--qso_list", nargs="+", required=True)
    parser.add_argument("--z_qso_list", nargs="+", type=float, required=True)
    parser.add_argument("--max_dlas", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument(
        "--output",
        default="processed_qsos_multi_meanflux.h5",
        help="catalog path; the suffix picks the container (.npz: numpy, "
        "anything else: HDF5 through h5py)",
    )
    parser.add_argument("--learned-file", default=None, help=".mat learned model")
    parser.add_argument("--catalog-file", default=None, help="catalog.mat")
    parser.add_argument("--los-catalog", default=None)
    parser.add_argument("--dla-catalog", default=None)
    parser.add_argument("--dla-samples-file", default=None)
    parser.add_argument("--subdla-samples-file", default=None)
    parser.add_argument(
        "--fit-nhi-prior",
        action="store_true",
        help="re-derive the logNHI sample prior from the --dla-catalog's "
        "own DLAs (KDE -> quadratic log-pdf fit) instead of the published "
        "Garnett coefficients (reference: generate_dla_samples.m:21-54)",
    )
    parser.add_argument(
        "--dtype",
        choices=["float32", "float64"],
        default="float32",
        help="pipeline dtype; float64 enables JAX's 64-bit mode",
    )
    parser.add_argument(
        "--release",
        choices=["dr12q", "dr14q"],
        default="dr12q",
        help="data release the spectra come from (selects the reader; "
        "reference: read_spec.py:22,74)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--num-devices",
        type=int,
        default=None,
        help="shard each batch over the first N local devices "
        "(default: all of them)",
    )
    parser.add_argument(
        "--num-samples",
        type=int,
        default=None,
        help="override the QMC sample count (default: Parameters default)",
    )
    parser.add_argument(
        "--plot-figures",
        action="store_true",
        help="write a per-spectrum model plot (sample-likelihood scatter "
        "+ MAP-absorbed mean) next to the output catalog "
        "(reference: run_bayes_select.py:238-244)",
    )
    parser.add_argument(
        "--checkpoint",
        action="store_true",
        help="persist every batch's results to a part file and resume "
        "from existing parts on rerun",
    )
    parser.add_argument(
        "--checkpoint-every",
        type=int,
        default=None,
        help=argparse.SUPPRESS,  # legacy alias: any N>0 behaves as --checkpoint
    )
    parser.add_argument(
        "--no-sample-lls",
        action="store_true",
        help="catalog-lite: omit the per-sample log-likelihood arrays "
        "and resampling indices from the readback and the catalog "
        "(~160 KB/spectrum -> ~3 KB; evidences/MAPs/posteriors are "
        "unaffected).  Use for surveys that don't feed the CDDF "
        "analysis; the default stays faithful to the reference catalog "
        "(reference: run_bayes_select.py:266-295)",
    )
    parser.add_argument(
        "--inflight",
        type=int,
        default=3,
        help="dispatched batches kept in flight on the device while the "
        "finalize thread drains readbacks (>=1; deeper absorbs readback "
        "latency spikes at the cost of device memory)",
    )
    args = parser.parse_args(argv)
    if args.no_sample_lls and args.plot_figures:
        parser.error(
            "--plot-figures needs the per-sample likelihoods that "
            "--no-sample-lls omits"
        )

    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax
    import jax.numpy as jnp

    if args.dtype == "float64":
        # without 64-bit mode every float64 array silently becomes f32
        jax.config.update("jax_enable_x64", True)

    from .data import loaders
    from .data.fits import spec_reader

    read_spec = spec_reader(args.release)
    from .data.samples import generate_dla_samples, generate_subdla_samples
    from .data.spectrum import preprocess
    from .data.synthetic import synthetic_learned_model, synthetic_prior_catalog
    from .catalog_io import write_catalog
    from .parallel.batch import make_spectra_mesh
    from .params import Parameters

    params = (
        Parameters(num_dla_samples=args.num_samples)
        if args.num_samples
        else Parameters()
    )

    if args.learned_file:
        learned = loaders.load_learned_model(args.learned_file)
    else:
        print("[warn] no --learned-file given; using a synthetic learned model")
        learned = synthetic_learned_model(params)

    if args.catalog_file:
        from .data.catalog import PriorCatalog

        prior = PriorCatalog.from_mat(
            params, args.catalog_file, args.los_catalog, args.dla_catalog
        )
    else:
        print("[warn] no --catalog-file given; using a synthetic prior catalog")
        prior = synthetic_prior_catalog(params)

    nhi_fit = None
    if args.fit_nhi_prior:
        if not args.dla_catalog:
            parser.error("--fit-nhi-prior requires --dla-catalog")
        if args.dla_samples_file or args.subdla_samples_file:
            # the fitted prior only shapes samples we generate ourselves
            parser.error(
                "--fit-nhi-prior conflicts with --dla-samples-file/"
                "--subdla-samples-file: samples loaded from a file keep "
                "the prior they were drawn from"
            )
        from .data.samples import fit_log_nhi_prior

        nhi_fit = fit_log_nhi_prior(np.loadtxt(args.dla_catalog)[:, 2], params)
        print(
            f"[info] fitted logNHI prior from {args.dla_catalog}: "
            f"exp({-nhi_fit.A:.4f} x^2 + {nhi_fit.B:.3f} x + {nhi_fit.C:.2f}), "
            f"peak {nhi_fit.peak:.3f}"
        )

    dla_samples = (
        loaders.load_dla_samples(args.dla_samples_file, params)
        if args.dla_samples_file
        else generate_dla_samples(params, fit=nhi_fit)
    )
    subdla_samples = (
        loaders.load_subdla_samples(args.subdla_samples_file, params)
        if args.subdla_samples_file
        else generate_subdla_samples(params, fit=nhi_fit)
    )

    from .utils.metrics import RunLogger

    devices = jax.devices()[: args.num_devices]

    metrics = RunLogger(
        args.output + ".metrics.jsonl",
        run_config=dict(
            num_spectra=len(args.qso_list),
            max_dlas=args.max_dlas,
            batch_size=args.batch_size,
            num_samples=params.num_dla_samples,
            dtype=args.dtype,
            devices=len(devices),
        ),
    )

    mesh = make_spectra_mesh(devices) if len(devices) > 1 else None
    dtype = jnp.float32 if args.dtype == "float32" else jnp.float64

    # commit the batch-invariant inputs to device memory once
    from .parallel.batch import device_put_inputs

    learned, dla_samples, subdla_samples = device_put_inputs(
        learned, dla_samples, subdla_samples, dtype, mesh=mesh
    )

    import collections
    import concurrent.futures
    import os
    import pickle

    from .utils.prefetch import prefetch_map

    checkpoint = args.checkpoint or bool(args.checkpoint_every)

    # batches stream through a host-side prefetcher: batch i+1 is read
    # and preprocessed on a worker thread while the device computes
    # batch i, and only the in-flight batches are resident (the
    # reference preloads the whole survey into preloaded_qsos.mat —
    # reference: preload_qsos.m:56-79)
    total = len(args.qso_list)
    starts = list(range(0, total, args.batch_size))

    def part_path(start):
        return f"{args.output}.part{start:08d}.pkl"

    def part_meta(start):
        """Identity of the batch a part file covers: parts are keyed by
        start offset only, so resuming with a different --batch-size or
        a reordered --qso_list must be detected, not silently misread
        as completed work."""
        return {
            "batch_size": args.batch_size,
            "files": list(args.qso_list[start : start + args.batch_size]),
        }

    def write_part(start, kept, errors, batch_results):
        with open(part_path(start), "wb") as f:
            pickle.dump((part_meta(start), kept, errors, batch_results), f)

    def read_part(start):
        with open(part_path(start), "rb") as f:
            payload = pickle.load(f)
        if len(payload) == 4:
            meta, kept, errors, batch_results = payload
            if meta != part_meta(start):
                raise SystemExit(
                    f"{part_path(start)} was written by a run with a "
                    "different --batch-size or --qso_list; delete the "
                    "part files or rerun with the original settings"
                )
            return kept, errors, batch_results
        return payload  # legacy 3-tuple part (predates the metadata)

    def load_batch(start):
        """Read + preprocess one batch on the worker thread, with
        per-spectrum failure capture (the reference records
        all_exceptions per QSO,
        multi_dlas/process_qsos_multiple_dlas_meanflux.m:222-233)."""
        resumed = checkpoint and os.path.exists(part_path(start))
        if resumed and not args.plot_figures:
            return start, None, [], []  # results come from the part file
        specs, kept, errors = [], [], []
        for idx in range(start, min(start + args.batch_size, total)):
            filename, z_qso = args.qso_list[idx], args.z_qso_list[idx]
            try:
                wavelengths, flux, noise_variance, pixel_mask = read_spec(
                    filename
                )
                specs.append(
                    preprocess(
                        wavelengths, flux, noise_variance, pixel_mask,
                        z_qso, params,
                    )
                )
                kept.append(idx)
            except Exception as e:
                errors.append((idx, filename, f"{type(e).__name__}: {e}"))
        return start, specs, kept, errors

    from .parallel.batch import dispatch_batch, finalize_batch

    results = []
    spectra_by_idx = {}  # retained only for --plot-figures
    kept_all, all_exceptions = [], []
    key = jax.random.PRNGKey(args.seed)
    keys = {s: k for s, k in zip(starts, jax.random.split(key, len(starts)))}
    t0 = time.time()
    done = computed = 0
    # device pipeline: up to --inflight dispatched batches stay queued
    # on the device while a dedicated finalize thread drains them
    # (device->host readback + model selection + part-file write).  The
    # GIL is released while a transfer waits, so finalize overlaps the
    # device compute; the deeper window means a latency spike on one
    # batch's readback never starves the device.
    window = max(1, args.inflight)
    inflight = collections.deque()  # (start, kept, errors, n, future, t)
    fin_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def finalize_job(start, specs, kept, errors, out):
        batch_results = finalize_batch(
            out, specs, subdla_samples, prior, args.max_dlas
        )
        if checkpoint:
            write_part(start, kept, errors, batch_results)
        return batch_results

    def drain_one():
        nonlocal done, computed
        start, kept, errors, n, future, t_batch = inflight.popleft()
        t_wait = time.time()
        batch_results = future.result()
        results.extend(batch_results)
        done += len(batch_results)
        computed += len(batch_results)
        rate = computed / (time.time() - t0)
        print(f"[{done}/{total}] {rate:.2f} spectra/sec")
        metrics.batch(
            index=start // args.batch_size,
            size=n,
            done=done,
            total=total,
            # main-thread wait on the finalize thread (~0 when fully
            # overlapped); span covers dispatch->drain including the
            # overlapped device compute of the newer in-flight batches
            seconds=time.time() - t_wait,
            span_seconds=round(time.time() - t_batch, 3),
        )

    def drain_all():
        while inflight:
            drain_one()

    for start, specs, kept, errors in prefetch_map(load_batch, starts):
        # step-granular checkpoint/resume: every batch's results persist
        # to a part file together with its kept indices and failures;
        # reruns skip completed batches entirely and reproduce the
        # original run's output (a crash reruns at most the in-flight
        # window's batches)
        if checkpoint and os.path.exists(part_path(start)):
            drain_all()  # keep results in batch order
            batch_kept, batch_errors, batch_results = read_part(start)
            # the part file is the source of truth for this batch: any
            # errors from the (optional, --plot-figures-only) re-read
            # are ignored — its spectra were already cataloged
            for idx, filename, msg in batch_errors:
                all_exceptions.append(idx)
            if specs is not None and args.plot_figures:
                spectra_by_idx.update(zip(kept, specs))
            results.extend(batch_results)
            kept_all.extend(batch_kept)
            done += len(batch_results)
            continue

        for idx, filename, msg in errors:
            print(f"[skip] {filename}: {msg}")
            metrics.failure(filename, msg)
            all_exceptions.append(idx)
        if specs is not None and args.plot_figures:
            spectra_by_idx.update(zip(kept, specs))
        kept_all.extend(kept)
        if not specs:
            if checkpoint:
                write_part(start, kept, errors, [])
            continue
        t_batch = time.time()
        out = dispatch_batch(
            learned,
            specs,
            dla_samples,
            subdla_samples,
            params,
            keys[start],
            args.max_dlas,
            mesh=mesh,
            dtype=dtype,
            with_sample_lls=not args.no_sample_lls,
        )
        inflight.append(
            (
                start,
                kept,
                errors,
                len(specs),
                fin_pool.submit(finalize_job, start, specs, kept, errors, out),
                t_batch,
            )
        )
        while len(inflight) >= window:
            drain_one()

    drain_all()
    fin_pool.shutdown()

    qso_list = [args.qso_list[i] for i in kept_all]
    z_qso_list = [args.z_qso_list[i] for i in kept_all]

    for r, name in zip(results, qso_list):
        print(
            f"{name}: p_dla={r.p_dla:.4f} "
            f"MAP z={r.map_z_dlas[0, 0]:.4f} logNHI={r.map_log_nhis[0, 0]:.3f}"
        )

    if args.plot_figures:
        import os as _os

        from .models.learned import build_spectrum_model
        from .plotting import plot_dla_model

        import matplotlib.pyplot as _plt

        plot_dir = args.output + "_figures"
        _os.makedirs(plot_dir, exist_ok=True)
        # results and kept_all are aligned; spectra are looked up by
        # catalog index so a resumed batch whose spectrum file can no
        # longer be read simply skips its figure (never misaligns)
        for r, idx, name in zip(results, kept_all, qso_list):
            spec = spectra_by_idx.get(idx)
            if spec is None:
                print(f"[figures] {name}: spectrum unavailable, skipped")
                continue
            model = build_spectrum_model(learned.astype(np.float64), spec, params)
            z_s = float(spec.min_z_dla) + (
                float(spec.max_z_dla) - float(spec.min_z_dla)
            ) * np.asarray(dla_samples.offset_samples)
            fig = plot_dla_model(
                model,
                params,
                sample_z_dlas=z_s,
                log_nhi_samples=np.asarray(dla_samples.log_nhi_samples),
                sample_log_likelihoods=r.sample_log_likelihoods_dla,
                map_z_dlas=r.map_z_dlas,
                map_log_nhis=r.map_log_nhis,
                nth_dla=max(int(np.argmax(r.selection.model_posteriors)) - 1, 1),
                title=f"{name}  p_dla={r.p_dla:.3f}",
            )
            base = _os.path.splitext(_os.path.basename(name))[0]
            fig.savefig(_os.path.join(plot_dir, f"{base}.png"), dpi=100)
            _plt.close(fig)  # survey-scale runs: don't retain figures
        print(f"wrote figures to {plot_dir}/")

    write_catalog(
        args.output, results, params, args.max_dlas, z_qso_list, qso_list,
        all_exceptions=all_exceptions,
    )
    metrics.finish(
        spectra_processed=len(results),
        spectra_failed=len(all_exceptions),
        spectra_per_sec=round(len(results) / max(time.time() - t0, 1e-9), 3),
        output=args.output,
    )
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
