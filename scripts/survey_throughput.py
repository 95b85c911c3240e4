"""Survey-driver throughput distribution: p50/p95 over repeated runs.

The end-to-end CLI rate varies run to run with host load, so this
script runs the full survey CLI N times over a synthetic survey and
reports the percentile distribution of the steady-state rate (computed
from the ``batch_done`` events of the ``.metrics.jsonl`` sidecar,
skipping the warm-up batches that include compilation).

The CLI runs as a child process that holds the accelerator; this
parent writes the synthetic spectra with JAX held to the CPU, so the
two never compete for the device.

Usage:
    python scripts/survey_throughput.py [--runs 5] [--spectra 192]
        [--batch-size 32] [--inflight 3] [--out runs/survey_tp]
        [--extra --no-sample-lls ...]

Everything after ``--extra`` is forwarded to run_bayes_select.  Prints
one JSON line with per-run steady rates and p50/p95.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_spectra(out_dir, n, params):
    import numpy as np

    from gpy_dla_detection_tpu.data.fits import write_speclite
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
    )

    learned = synthetic_learned_model(params)
    z_list = []
    for i in range(n):
        z = 2.8 + 0.3 * (i % 7) / 7.0
        dlas = [(z - 0.35, 20.8 + 0.1 * (i % 5))] if i % 3 == 0 else None
        wl, fx, nv, pm = synthetic_observation(
            params, learned, z, seed=i, dlas=dlas
        )
        write_speclite(
            os.path.join(out_dir, f"spec-0001-55555-{i:04d}.fits"),
            fx.astype(np.float32),
            np.log10(wl).astype(np.float32),
            (1.0 / nv).astype(np.float32),
            np.where(pm, 1 << 24, 0).astype(np.int32),
        )
        z_list.append(z)
    return z_list


def steady_rate(metrics_path, skip_batches=2):
    """Steady-state spectra/sec from the metrics sidecar: total spectra
    over total span for every batch after the first ``skip_batches``
    (those amortize compilation + pipeline fill)."""
    events = []
    with open(metrics_path) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("event") == "batch_done":
                events.append(ev)
    events.sort(key=lambda e: e["batch_index"])
    # the steady span needs a preceding event as its time origin, so at
    # least skip_batches+1 (>= 2) batches must exist
    skip_batches = max(skip_batches, 1)
    if len(events) <= skip_batches:
        raise SystemExit(f"only {len(events)} batches; need > {skip_batches}")
    tail = events[skip_batches:]
    t0 = events[skip_batches - 1]["elapsed_s"]
    spectra = sum(e["batch_size"] for e in tail)
    seconds = tail[-1]["elapsed_s"] - t0
    return spectra / seconds


def percentile(xs, q):
    xs = sorted(xs)
    i = (len(xs) - 1) * q
    lo, hi = int(i), min(int(i) + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (i - lo)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--spectra", type=int, default=192)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--inflight", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "survey_tp"))
    ap.add_argument("--skip-batches", type=int, default=2)
    ap.add_argument(
        "--extra", action="store_true",
        help="must come last: every argument after it is forwarded to "
        "run_bayes_select (e.g. --extra --no-sample-lls for the "
        "catalog-lite transport)",
    )
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = []
    if "--extra" in argv:
        i = argv.index("--extra")
        argv, extra = argv[: i + 1], argv[i + 1 :]
    args = ap.parse_args(argv)

    # the child CLI holds the accelerator: keep this process's JAX (used
    # only to synthesize spectra) on the CPU
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, REPO)
    from gpy_dla_detection_tpu.params import Parameters

    params = Parameters()
    names = [
        os.path.join(args.out, f"spec-0001-55555-{i:04d}.fits")
        for i in range(args.spectra)
    ]
    if not all(os.path.exists(n) for n in names):
        z_list = make_spectra(args.out, args.spectra, params)
        with open(os.path.join(args.out, "z_list.json"), "w") as f:
            json.dump(z_list, f)
    else:
        with open(os.path.join(args.out, "z_list.json")) as f:
            z_list = json.load(f)

    rates, walls = [], []
    for r in range(args.runs):
        out_h5 = os.path.join(args.out, f"run{r}.h5")
        for suffix in ("", ".metrics.jsonl"):
            if os.path.exists(out_h5 + suffix):
                os.remove(out_h5 + suffix)
        t0 = time.time()
        # tee the child's output to a per-run log so a failing run
        # leaves its traceback (and the completed runs' rates survive
        # in stderr above) instead of a bare CalledProcessError
        log_path = os.path.join(args.out, f"run{r}.log")
        with open(log_path, "wb") as log:
            proc = subprocess.run(
                [
                    sys.executable, "-m", "gpy_dla_detection_tpu.run_bayes_select",
                    "--qso_list", *names,
                    "--z_qso_list", *[f"{z}" for z in z_list],
                    "--batch-size", str(args.batch_size),
                    "--inflight", str(args.inflight),
                    "--output", out_h5,
                    *extra,
                ],
                env=env,
                cwd=REPO,
                stdout=log,
                stderr=subprocess.STDOUT,
            )
        if proc.returncode != 0:
            raise SystemExit(
                f"run {r} failed (exit {proc.returncode}); see {log_path}"
            )
        wall = time.time() - t0
        rate = steady_rate(out_h5 + ".metrics.jsonl", args.skip_batches)
        rates.append(rate)
        walls.append(wall)
        print(
            f"run {r}: steady {rate:.1f} spectra/s, wall {wall:.0f}s",
            file=sys.stderr,
        )

    print(
        json.dumps(
            {
                "metric": "survey CLI steady-state throughput",
                "unit": "spectra/sec",
                "runs": [round(r, 2) for r in rates],
                "wall_s": [round(w, 1) for w in walls],
                "p50": round(percentile(rates, 0.5), 2),
                "p95": round(percentile(rates, 0.95), 2),
                "min": round(min(rates), 2),
                "max": round(max(rates), 2),
                "spectra": args.spectra,
                "batch_size": args.batch_size,
                "inflight": args.inflight,
            }
        )
    )


if __name__ == "__main__":
    main()
