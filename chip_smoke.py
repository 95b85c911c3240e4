#!/usr/bin/env python3
"""Smoke test: Bayesian DLA model selection end to end on one GPU, at the
full width of the reference deployment (rank-20 GP, 10,000 QMC samples,
1,280 padded pixels, null + subDLA + 1-4 DLA models).

Run from the root of a checkout:

    python chip_smoke.py                # one card: phases 1-5, card tests
    python chip_smoke.py --four-cards   # only the multi-device path (phase 6)

Phases:

1. device    — JAX must report a GPU; prints it, the JAX version,
               XLA_FLAGS, the compile-cache directory and the card's
               name and power limit from nvidia-smi.
2. compile   — the batched evidence step at batch 8 (the CLI default)
               and 32, with ``compiled.memory_analysis()``.
3. main path — 64 synthetic SDSS FITS spectra through
               ``run_bayes_select.main`` (max_dlas 4, 10,000 samples,
               batch 8, --checkpoint); the catalog must flag every
               injected DLA at the right redshift and no clean spectrum.
4. reference — three of those spectra recomputed with the f64 exact
               path on the same resampling indices; the f32 catalog must
               agree within the stated tolerances.
5. variants  — the windowed Voigt and packed i16p profile storage
               against the same reference, and timed against the
               default step in turns.
6. four cards (--four-cards only) — the CLI sharded over four devices
               against the same spectra on one device.

Every phase that fails ends the run with a non-zero exit code.  The last
line of standard output is one JSON object, printed only on success:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(REPO, "runs", "chip_smoke")

# f32 catalog against the f64 reference on identical resampling indices.
# null: one Woodbury solve over ~1,250 pixels in f32, whose log-det and
# quadratic terms add to ~5e3 against a total of ~1e3, so f32 rounding is
# ~1e-5 of the total (measured 1.4-1.9e-5 on an H100): rtol 5e-5.  DLA and
# subDLA evidences: a log-sum-exp over 10,000 per-sample likelihoods, each
# of magnitude ~1e3 and carrying f32 rounding of the (S, N) profile
# products (rtol 2e-3).  Posteriors and p_dla: atol 2e-3.  A float32
# product that silently ran in TF32 (~1e-3 relative per product) moves
# the evidences by whole units and breaks these bounds.
TOL = {"null_rtol": 5e-5, "ev_rtol": 2e-3, "p_atol": 2e-3}

# detection checks of the main path
P_DLA_INJECTED = 0.9
P_DLA_CLEAN = 0.1
MAP_Z_TOL = 0.01


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi():
    """The card's name and power limit, read by a child process that
    does not import JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi did not run: {e}")
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# --------------------------------------------------------------------------
# phase 1: device


def phase_device():
    import jax

    from gpy_dla_detection_tpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devices[0].platform!r})")
    card = nvidia_smi()
    log(f"[device] kind={devices[0].device_kind} count={len(devices)} "
        f"jax={jax.__version__}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache}")
    log(f"[device] card: {card}")
    return card


# --------------------------------------------------------------------------
# shared set-up


def make_model_inputs(params):
    """Synthetic learned model, prior catalog and QMC samples (all from
    fixed seeds), as the CLI builds them when given no files."""
    from gpy_dla_detection_tpu.data.samples import (
        generate_dla_samples,
        generate_subdla_samples,
    )
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_prior_catalog,
    )

    return (
        synthetic_learned_model(params),
        synthetic_prior_catalog(params),
        generate_dla_samples(params),
        generate_subdla_samples(params),
    )


def batch_step_args(params, learned, dla_s, sub_s, batch, seed=0):
    """Device-committed arguments of the batched evidence step for a
    batch of ``batch`` synthetic f32 spectra."""
    import jax
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.data.spectrum import astype, stack
    from gpy_dla_detection_tpu.data.synthetic import synthetic_spectrum
    from gpy_dla_detection_tpu.parallel.batch import device_put_inputs

    learned_d, dla_d, sub_d = device_put_inputs(learned, dla_s, sub_s, jnp.float32)
    specs = stack([
        astype(synthetic_spectrum(
            params, learned, 2.8 + 0.05 * i, seed=seed + i,
            dlas=[(2.5 + 0.04 * i, 21.0)] if i % 2 else None,
        ), np.float32)
        for i in range(batch)
    ])
    specs = jax.tree.map(jnp.asarray, specs)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    return (learned_d, specs, dla_d.offset_samples, dla_d.log_nhi_samples,
            dla_d.nhi_samples, sub_d.offset_samples, sub_d.log_nhi_samples,
            sub_d.nhi_samples, keys)


# --------------------------------------------------------------------------
# phase 2: compile


def phase_compile(params, learned, dla_s, sub_s, batch_sizes=(8, 32),
                  max_dlas=4):
    """Lower and compile the batched evidence step at each batch size
    and print its memory analysis."""
    import jax

    from gpy_dla_detection_tpu.parallel.batch import _batched_evidences

    dev = jax.devices()[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    report = {}
    for b in batch_sizes:
        args = batch_step_args(params, learned, dla_s, sub_s, b)
        t0 = time.perf_counter()
        compiled = _batched_evidences.lower(
            *args, params=params, max_dlas=max_dlas, share_unit_tau=True
        ).compile()
        secs = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        need = (ma.argument_size_in_bytes + ma.output_size_in_bytes
                + ma.temp_size_in_bytes + ma.generated_code_size_in_bytes
                - ma.alias_size_in_bytes)
        fits = limit is None or need <= limit
        log(f"[compile] batch={b} compile_s={secs:.1f} "
            f"argument={ma.argument_size_in_bytes} "
            f"output={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
            f"code={ma.generated_code_size_in_bytes} "
            f"total={need} device_limit={limit}")
        if not fits:
            log(f"[compile] batch={b} does NOT fit in device memory "
                f"({need} > {limit} bytes); widths are not shrunk")
        report[b] = {"total_bytes": need, "temp_bytes": ma.temp_size_in_bytes,
                     "fits": fits, "compile_s": secs}
    return report


# --------------------------------------------------------------------------
# phase 3: main path through the CLI


def write_survey(params, learned, out_dir, n=64, seed=0):
    """``n`` synthetic SDSS FITS spectra at z_qso spread evenly over
    [2.3, 5.0]; every other spectrum with z_qso >= 2.8 carries one DLA at
    z_qso - 0.3 with logNHI in [20.8, 21.5].  Returns (files, z_qsos,
    truth) with truth[i] = (z_dla, logNHI) or None."""
    from gpy_dla_detection_tpu.data.fits import write_speclite
    from gpy_dla_detection_tpu.data.synthetic import synthetic_observation

    os.makedirs(out_dir, exist_ok=True)
    z_qsos = np.round(np.linspace(2.3, 5.0, n), 4)
    files, truth = [], []
    for i, z in enumerate(z_qsos):
        dla = None
        if i % 2 and z >= 2.8:
            dla = (round(float(z) - 0.3, 4), 20.8 + 0.7 * (i % 8) / 7.0)
        wl, fx, nv, pm = synthetic_observation(
            params, learned, float(z), seed=seed + i,
            dlas=[dla] if dla else None,
        )
        path = os.path.join(out_dir, f"spec-0001-55555-{i:04d}.fits")
        write_speclite(
            path,
            fx.astype(np.float32),
            np.log10(wl).astype(np.float32),
            (1.0 / nv).astype(np.float32),
            np.where(pm, 1 << 24, 0).astype(np.int32),
        )
        files.append(path)
        truth.append(dla)
    return files, [float(z) for z in z_qsos], truth


def run_cli(files, z_qsos, output, num_samples=None, batch_size=8,
            dtype="float32", extra=()):
    """One in-process ``run_bayes_select`` call; returns the catalog."""
    from gpy_dla_detection_tpu import run_bayes_select
    from gpy_dla_detection_tpu.catalog_io import read_catalog

    argv = [
        "--qso_list", *files,
        "--z_qso_list", *[repr(z) for z in z_qsos],
        "--max_dlas", "4",
        "--batch-size", str(batch_size),
        "--checkpoint",
        "--dtype", dtype,
        "--output", output,
        *extra,
    ]
    if num_samples:
        argv += ["--num-samples", str(num_samples)]
    run_bayes_select.main(argv)
    return read_catalog(output)


def steady_rate(metrics_path, skip_batches=2):
    """Spectra/s over the batches after the first ``skip_batches`` (which
    include compilation), from the CLI's metrics sidecar."""
    events = []
    with open(metrics_path) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("event") == "batch_done":
                events.append(ev)
    events.sort(key=lambda e: e["batch_index"])
    if len(events) <= skip_batches:
        return None
    tail = events[skip_batches:]
    seconds = tail[-1]["elapsed_s"] - events[skip_batches - 1]["elapsed_s"]
    return sum(e["batch_size"] for e in tail) / seconds


def check_catalog(cat, truth):
    """Finite evidences; injected DLAs found at the right redshift;
    clean spectra left clean."""
    n = len(truth)
    if len(cat["p_dlas"]) != n:
        fail(f"catalog holds {len(cat['p_dlas'])} spectra, expected {n}")
    for name in ("log_likelihoods_no_dla", "log_likelihoods_lls",
                 "log_likelihoods_dla"):
        bad = ~np.isfinite(cat[name])
        if bad.any():
            fail(f"{name} not finite for spectra "
                 f"{sorted(set(np.nonzero(bad)[0].tolist()))}")
    worst_inj, worst_clean, worst_z = 1.0, 0.0, 0.0
    for i, t in enumerate(truth):
        p = float(cat["p_dlas"][i])
        if t is None:
            worst_clean = max(worst_clean, p)
            if p >= P_DLA_CLEAN:
                fail(f"clean spectrum {i} has p_dla={p:.4f}")
            continue
        dz = abs(float(cat["MAP_z_dlas"][i, 0, 0]) - t[0])
        worst_inj, worst_z = min(worst_inj, p), max(worst_z, dz)
        if p <= P_DLA_INJECTED:
            fail(f"injected spectrum {i} (z_dla={t[0]}) has p_dla={p:.4f}")
        if dz >= MAP_Z_TOL:
            fail(f"injected spectrum {i}: MAP z_dla off by {dz:.4f}")
    log(f"[main] catalog checks passed: {n} spectra, "
        f"{sum(t is not None for t in truth)} injected; min p_dla(injected)="
        f"{worst_inj:.6f} max p_dla(clean)={worst_clean:.3e} "
        f"max |MAP z - truth|={worst_z:.5f}")


def phase_main_path(params, learned, out_dir, n=64, num_samples=None,
                    batch_size=8, dtype="float32", card=None):
    for stale in ("cli", "spectra"):
        shutil.rmtree(os.path.join(out_dir, stale), ignore_errors=True)
    files, z_qsos, truth = write_survey(
        params, learned, os.path.join(out_dir, "spectra"), n
    )
    os.makedirs(os.path.join(out_dir, "cli"))
    output = os.path.join(out_dir, "cli", "catalog.npz")
    t0 = time.perf_counter()
    cat = run_cli(files, z_qsos, output, num_samples, batch_size, dtype)
    log(f"[main] CLI wall {time.perf_counter() - t0:.1f}s "
        f"(compilation included)")
    check_catalog(cat, truth)
    rate = steady_rate(output + ".metrics.jsonl")
    if rate is not None:
        log(f"[main] steady-state {rate:.2f} spectra/s (CLI, batch "
            f"{batch_size}, informative only) on card: {card}")
    return files, z_qsos, truth, cat


# --------------------------------------------------------------------------
# phases 4 and 5: f64 reference, and the selectable variants against it


def pinned_evidences(params, max_dlas, dtype, voigt_impl=None, abs_dtype=None):
    """A jitted (null, subDLA, DLA) evidence function for one spectrum
    with the DLA chain's resampling indices given, in ``dtype``."""
    import jax

    from gpy_dla_detection_tpu.models.evidence import (
        null_log_evidence,
        qmc_log_evidences,
    )
    from gpy_dla_detection_tpu.models.learned import build_spectrum_model

    def run(learned, spec, samples, base):
        d_off, d_lognhi, d_nhi, s_off, s_lognhi, s_nhi = samples
        model = build_spectrum_model(learned, spec, params)
        key = jax.random.PRNGKey(0)  # unused: the DLA chain is pinned
        kw = dict(voigt_impl=voigt_impl, abs_dtype=abs_dtype)
        dla = qmc_log_evidences(model, d_off, d_lognhi, d_nhi, key, max_dlas,
                                params, base_inds_override=base, **kw)
        sub = qmc_log_evidences(model, s_off, s_lognhi, s_nhi, key, 1,
                                params, **kw)
        return null_log_evidence(model), sub.log_evidences, dla.log_evidences

    return jax.jit(run)


def evaluate_pinned(fn, dtype, params, learned, dla_s, sub_s, files, z_qsos,
                    picks, cat):
    """Run ``fn`` on the picked spectra (read back from their FITS files)
    with the catalog's resampling indices."""
    import jax.numpy as jnp

    from gpy_dla_detection_tpu.data.fits import read_spec
    from gpy_dla_detection_tpu.data.spectrum import astype, preprocess

    c = lambda x: jnp.asarray(np.asarray(x), dtype)
    samples = tuple(c(x) for x in (
        dla_s.offset_samples, dla_s.log_nhi_samples, dla_s.nhi_samples,
        sub_s.offset_samples, sub_s.log_nhi_samples, sub_s.nhi_samples))
    learned_c = learned.astype(dtype)
    out = []
    for i in picks:
        spec = astype(preprocess(*read_spec(files[i]), z_qsos[i], params), dtype)
        base = jnp.asarray(cat["base_sample_inds"][i].T, jnp.int32)
        null, sub, dla = fn(learned_c, spec, samples, base)
        out.append((float(null), np.asarray(sub, np.float64),
                    np.asarray(dla, np.float64)))
    return out


def selection(prior, sub_s, z_qso, null, sub, dla, max_dlas):
    from gpy_dla_detection_tpu.models.selection import (
        log_priors_k_dlas,
        log_priors_subdla,
        model_selection,
    )

    num_dlas, num_quasars = prior.less_ind(float(z_qso))
    sel = model_selection(
        log_priors_subdla(num_dlas, num_quasars, sub_s.Z_lls, sub_s.Z_dla),
        log_priors_k_dlas(num_dlas, num_quasars, max_dlas),
        null, sub, dla,
    )
    return np.asarray(sel.model_posteriors), float(sel.p_dla)


def compare(name, got, ref, prior, sub_s, z_qsos, picks, max_dlas):
    """Largest f32-vs-f64 deltas over the picked spectra, checked against
    TOL.  ``got``/``ref`` are lists of (null, sub, dla) per spectrum."""
    worst = {"null_rel": 0.0, "sub_rel": 0.0, "dla_rel": 0.0,
             "posterior_abs": 0.0, "p_dla_abs": 0.0}
    for (gn, gs, gd), (rn, rs, rd), i in zip(got, ref, picks):
        gpost, gp = selection(prior, sub_s, z_qsos[i], gn, gs, gd, max_dlas)
        rpost, rp = selection(prior, sub_s, z_qsos[i], rn, rs, rd, max_dlas)
        worst["null_rel"] = max(worst["null_rel"], abs(gn - rn) / abs(rn))
        worst["sub_rel"] = max(worst["sub_rel"],
                               float(np.max(np.abs(gs - rs) / np.abs(rs))))
        worst["dla_rel"] = max(worst["dla_rel"],
                               float(np.max(np.abs(gd - rd) / np.abs(rd))))
        worst["posterior_abs"] = max(worst["posterior_abs"],
                                     float(np.max(np.abs(gpost - rpost))))
        worst["p_dla_abs"] = max(worst["p_dla_abs"], abs(gp - rp))
    limits = {"null_rel": TOL["null_rtol"], "sub_rel": TOL["ev_rtol"],
              "dla_rel": TOL["ev_rtol"], "posterior_abs": TOL["p_atol"],
              "p_dla_abs": TOL["p_atol"]}
    log(f"[{name}] largest deltas vs f64 reference: " + ", ".join(
        f"{k}={worst[k]:.3e} (limit {limits[k]:.0e})" for k in worst))
    for k, v in worst.items():
        if not v <= limits[k]:
            fail(f"{name}: {k}={v:.3e} exceeds {limits[k]:.0e}")
    return worst


def pick_reference_spectra(z_qsos, truth):
    """One clean spectrum, one with a DLA, and the lowest z_qso."""
    lowest = int(np.argmin(z_qsos))
    clean = [i for i, t in enumerate(truth) if t is None and i != lowest]
    injected = [i for i, t in enumerate(truth) if t is not None]
    return [clean[len(clean) // 2], injected[len(injected) // 2], lowest]


def phase_reference(params, learned, prior, dla_s, sub_s, files, z_qsos,
                    truth, cat, max_dlas=4):
    import jax
    import jax.numpy as jnp

    picks = pick_reference_spectra(z_qsos, truth)
    with jax.enable_x64(True):
        fn = pinned_evidences(params, max_dlas, jnp.float64, "exact",
                              jnp.float64)
        ref = evaluate_pinned(fn, jnp.float64, params, learned, dla_s, sub_s,
                              files, z_qsos, picks, cat)
    got = [(float(cat["log_likelihoods_no_dla"][i]),
            np.asarray(cat["log_likelihoods_lls"][i], np.float64).reshape(1),
            np.asarray(cat["log_likelihoods_dla"][i], np.float64))
           for i in picks]
    log(f"[reference] spectra {picks} (z_qso "
        f"{[z_qsos[i] for i in picks]}): f64 exact path, catalog "
        f"resampling indices")
    # the catalog's own posteriors must be those of its evidences
    for i, (null, sub, dla) in zip(picks, got):
        post, p = selection(prior, sub_s, z_qsos[i], null, sub, dla, max_dlas)
        if not (np.allclose(post, cat["model_posteriors"][i], atol=1e-6)
                and abs(p - float(cat["p_dlas"][i])) <= 1e-6):
            fail(f"catalog posteriors of spectrum {i} do not follow from "
                 "its evidences")
    compare("reference", got, ref, prior, sub_s, z_qsos, picks, max_dlas)
    return picks, ref


def time_steps(params, learned, dla_s, sub_s, variants, batch=8, rounds=3,
               reps=5, max_dlas=4):
    """Median seconds per batched evidence step for each variant, timed
    in turns (ABC CBA ...) with block_until_ready."""
    import jax

    from gpy_dla_detection_tpu.parallel.batch import _batched_evidences

    args = batch_step_args(params, learned, dla_s, sub_s, batch)
    steps = {
        name: (lambda kw=kw: _batched_evidences(
            *args, params=params, max_dlas=max_dlas, share_unit_tau=True, **kw))
        for name, kw in variants.items()
    }
    for step in steps.values():  # compile + warm
        jax.block_until_ready(step())
    times = {name: [] for name in steps}
    order = list(steps)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(steps[name]())
                times[name].append(time.perf_counter() - t0)
    return {name: float(np.median(t)) for name, t in times.items()}


VARIANTS = {
    "windowed": {"voigt_impl": "windowed"},
    "i16p": {"abs_dtype": "i16p"},
}


def phase_variants(params, learned, prior, dla_s, sub_s, files, z_qsos,
                   picks, ref, cat, card=None, max_dlas=4, variants=VARIANTS,
                   timing=True):
    import jax.numpy as jnp

    for name, kw in variants.items():
        fn = pinned_evidences(params, max_dlas, jnp.float32, **kw)
        got = evaluate_pinned(fn, jnp.float32, params, learned, dla_s, sub_s,
                              files, z_qsos, picks, cat)
        compare(name, got, ref, prior, sub_s, z_qsos, picks, max_dlas)
    if not timing:
        return None
    medians = time_steps(params, learned, dla_s, sub_s,
                         {"default": {}, **variants})
    for name, t in medians.items():
        log(f"[variants] {name}: {t * 1e3:.3f} ms per batch of 8 "
            f"({8 / t:.1f} spectra/s, median, informative only) on card: {card}")
    return medians


# --------------------------------------------------------------------------
# card-only tests


def phase_card_tests():
    """The tests marked ``gpu``, run in this process (one process holds
    the card)."""
    import pytest

    rc = pytest.main([
        os.path.join(REPO, "tests", "test_gpu.py"), "-q", "-m", "gpu",
        "-p", "no:cacheprovider", "-p", "no:randomly",
    ])
    if rc != 0:
        fail(f"card-only tests failed (pytest exit {int(rc)})")
    log("[card tests] passed")


# --------------------------------------------------------------------------
# phase 6: four cards


def compare_catalogs(a, b):
    """Largest differences between two catalogs of the same spectra."""
    worst = {
        "null_rel": float(np.max(np.abs(a["log_likelihoods_no_dla"]
                                        - b["log_likelihoods_no_dla"])
                                 / np.abs(b["log_likelihoods_no_dla"]))),
        "lls_rel": float(np.max(np.abs(a["log_likelihoods_lls"]
                                       - b["log_likelihoods_lls"])
                                / np.abs(b["log_likelihoods_lls"]))),
        "dla_rel": float(np.max(np.abs(a["log_likelihoods_dla"]
                                       - b["log_likelihoods_dla"])
                                / np.abs(b["log_likelihoods_dla"]))),
        "p_dla_abs": float(np.max(np.abs(a["p_dlas"] - b["p_dlas"]))),
        "posterior_abs": float(np.max(np.abs(a["model_posteriors"]
                                             - b["model_posteriors"]))),
    }
    same_inds = float(np.mean(a["base_sample_inds"] == b["base_sample_inds"]))
    return worst, same_inds


def phase_four_cards(params, learned, out_dir, n=64, num_samples=None,
                     card=None, dtype="float32"):
    """The CLI over four devices, then the same spectra on one device
    in this process; the two catalogs must agree.  Each spectrum gets
    the same PRNG key either way, so the two runs differ only in how the
    batch is split: the same tolerances as the f64 comparison apply."""
    import jax

    if len(jax.devices()) < 4:
        fail(f"--four-cards needs 4 devices, JAX found {len(jax.devices())}")
    shutil.rmtree(os.path.join(out_dir, "four"), ignore_errors=True)
    files, z_qsos, truth = write_survey(
        params, learned, os.path.join(out_dir, "four", "spectra"), n
    )
    cats = {}
    for ndev in (4, 1):
        out = os.path.join(out_dir, "four", f"catalog_{ndev}dev.npz")
        t0 = time.perf_counter()
        cats[ndev] = run_cli(files, z_qsos, out, num_samples, dtype=dtype,
                             extra=("--num-devices", str(ndev)))
        rate = steady_rate(out + ".metrics.jsonl")
        log(f"[four cards] {ndev} device(s): wall "
            f"{time.perf_counter() - t0:.1f}s, steady-state "
            f"{rate if rate is None else round(rate, 2)} spectra/s "
            f"(informative only) on card: {card}")
        check_catalog(cats[ndev], truth)
    worst, same_inds = compare_catalogs(cats[4], cats[1])
    limits = {"null_rel": TOL["null_rtol"], "lls_rel": TOL["ev_rtol"],
              "dla_rel": TOL["ev_rtol"], "p_dla_abs": TOL["p_atol"],
              "posterior_abs": TOL["p_atol"]}
    log("[four cards] 4-device vs 1-device catalog: " + ", ".join(
        f"{k}={worst[k]:.3e} (limit {limits[k]:.0e})" for k in worst)
        + f", identical resampling indices: {same_inds:.6f}")
    for k, v in worst.items():
        if not v <= limits[k]:
            fail(f"four cards: {k}={v:.3e} exceeds {limits[k]:.0e}")


# --------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path (needs 4 GPUs)")
    args = ap.parse_args(argv)

    if os.path.abspath(sys.path[0] or ".") != REPO:
        sys.path.insert(0, REPO)
    try:
        from gpy_dla_detection_tpu.params import Parameters
    except ImportError as e:
        fail(f"the package is not next to this script ({e})")

    t_start = time.perf_counter()
    card = phase_device()
    import jax

    params = Parameters()  # the reference deployment, at full width
    learned, prior, dla_s, sub_s = make_model_inputs(params)
    if args.four_cards:
        phase_four_cards(params, learned, WORKDIR, card=card)
    else:
        phase_compile(params, learned, dla_s, sub_s)
        files, z_qsos, truth, cat = phase_main_path(
            params, learned, WORKDIR, card=card
        )
        picks, ref = phase_reference(params, learned, prior, dla_s, sub_s,
                                     files, z_qsos, truth, cat)
        phase_variants(params, learned, prior, dla_s, sub_s, files, z_qsos,
                       picks, ref, cat, card=card)
        phase_card_tests()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s; "
        f"card: {card}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
