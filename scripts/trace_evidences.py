"""Trace the batched evidence step on the GPU and split its device time
by the pipeline's named scopes.

The step is the CLI's: batch 8 at the full width of the reference
deployment (S=10,000, N=1,280, k=20, null + subDLA + 4 DLA levels).  It
is compiled and warmed, then a short window of steps runs under
``jax.profiler``.  Each device kernel is attributed to the named scope
(``jax.named_scope`` in models/evidence.py, ops/logmvn.py and
parallel/batch.py) of the HLO instruction it comes from:

    absorption   Voigt unit optical depth, exp and broadening
    capacitance  the (S, N) x (N, k^2) and (S, N) x (N, k) products
    quad_logdet  the unrolled k x k Cholesky chain
    resample     the importance resampling and chained-profile gathers
    likelihood   the rest of the Woodbury composition
    other        everything else (null evidence, spectrum model, ...)

Usage (needs a GPU; prints one JSON line, writes the raw trace under
chiprun_out/trace_evidences/):

    python scripts/trace_evidences.py [--steps 5]
"""

import argparse
import glob
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from gpy_dla_detection_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import jax  # noqa: E402

SCOPES = ("quad_logdet", "capacitance", "resample", "absorption", "likelihood")


def hlo_scopes(hlo_text):
    """HLO instruction name -> scope, from the op_name metadata of the
    optimized module (a fusion carries its root instruction's name).
    Kernel names in the trace spell the instruction name with "_" for
    ".", so both spellings are keys."""
    out = {}
    for m in re.finditer(r"%([\w.-]+) = [^\n]*?op_name=\"([^\"]*)\"", hlo_text):
        name, op_name = m.groups()
        scope = next(
            (s for s in SCOPES if re.search(rf"(^|[/(]){s}([/)]|$)", op_name)),
            "other",
        )
        out[name] = out[name.replace(".", "_")] = scope
    return out


def kernel_scope(name, scopes):
    """Scope of one device kernel: by its HLO instruction, else a cuBLAS
    GEMM (in this step, the capacitance products), else other."""
    if name in scopes:
        return scopes[name]
    if "gemm" in name or name.startswith(("sm80_", "sm90_", "nvjet", "cutlass")):
        return "capacitance"
    return "other"


def reduce_trace(path, scopes):
    """Per-scope device time, busy time and window of a GPU trace."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    per_line, events, by_line = {}, [], {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                dur = ev.duration_ns
                per_line[line.name] = per_line.get(line.name, 0) + dur
                if len(events) < 400:
                    events.append([line.name, ev.name, dur,
                                   {k: str(v)[:200] for k, v in stats.items()}])
                hlo = str(stats.get("hlo_op") or ev.name)
                if hlo == "command_buffer":  # kernels replayed as a CUDA graph
                    hlo = ev.name
                by_line.setdefault(line.name, []).append((ev.start_ns, dur, hlo))
    # one event per executed HLO op: the "XLA Ops" line when the trace
    # has it, else the kernels on the streams
    if "XLA Ops" in by_line:
        ops = by_line["XLA Ops"]
    else:
        ops = [e for name, evs in by_line.items() if name.startswith("Stream")
               for e in evs]
    per_scope, intervals = {}, []
    for start, dur, hlo in ops:
        scope = kernel_scope(hlo, scopes)
        per_scope[scope] = per_scope.get(scope, 0) + dur
        intervals.append((start, start + dur))
    intervals.sort()
    busy, end = 0.0, -1.0
    for s, e in intervals:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    return per_scope, per_line, busy, window, events


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "trace_evidences"))
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("trace_evidences: no GPU")

    import chip_smoke as cs
    from gpy_dla_detection_tpu.params import Parameters
    from gpy_dla_detection_tpu.parallel.batch import _batched_evidences

    params = Parameters()
    learned, _, dla_s, sub_s = cs.make_model_inputs(params)
    step_args = cs.batch_step_args(params, learned, dla_s, sub_s, args.batch)
    compiled = _batched_evidences.lower(
        *step_args, params=params, max_dlas=4, share_unit_tau=True
    ).compile()
    scopes = hlo_scopes(compiled.as_text())
    for _ in range(3):
        jax.block_until_ready(compiled(*step_args))
    t0 = time.perf_counter()
    for _ in range(args.steps):
        jax.block_until_ready(compiled(*step_args))
    step_s = (time.perf_counter() - t0) / args.steps

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        for _ in range(args.steps):
            jax.block_until_ready(compiled(*step_args))
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    per_scope, per_line, busy, window, events = reduce_trace(path, scopes)
    with open(os.path.join(args.out, "events_sample.json"), "w") as f:
        json.dump(events, f)
    total = sum(per_scope.values()) or 1
    dev = jax.devices()[0]
    print(json.dumps({
        "device": dev.device_kind,
        "batch": args.batch,
        "steps": args.steps,
        "step_ms_untraced": round(step_s * 1e3, 3),
        "kernel_ms_per_step": {k: round(v / 1e6 / args.steps, 4)
                               for k, v in sorted(per_scope.items())},
        "kernel_share": {k: round(v / total, 4)
                         for k, v in sorted(per_scope.items())},
        "busy_ms_per_step": round(busy / 1e6 / args.steps, 4),
        "idle_share": round(1 - busy / window, 4) if window else None,
        "per_line_ms": {k: round(v / 1e6, 3) for k, v in per_line.items()},
        "hlo_instructions": len(scopes),
    }))


if __name__ == "__main__":
    main()
