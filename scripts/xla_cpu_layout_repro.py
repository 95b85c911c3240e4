"""Minimal repro of the XLA:CPU fusion-emitter miscompile that broke
round-3's multichip dryrun (MULTICHIP_r03.json), recorded per VERDICT r3
item 1.

The production QMC evidence program with PACKED i16-pair profile storage
(abs_dtype="i16p"), compiled for a sample-sharded 8-device host
mesh, computes level-1 per-sample log-likelihoods that differ from the
single-device compile by O(100).  The bisect (round 4):

* the wrong side is the SHARDED compile: against an f64 oracle the
  unsharded f32 program agrees to 0.017, the sharded one is off by 67+;
* the corruption is NOT in the repo math: every op in isolation
  (encode, decode, gather, matmul) is bit-identical sharded vs
  unsharded; the error appears only in the fused whole program;
* ``--xla_disable_hlo_passes=fusion`` makes the sharded compile agree
  to 6e-5 -> an XLA:CPU *fusion emitter* bug, not an SPMD partitioner
  bug (the partitioned HLO is semantically sound);
* forcing the pre-pack f32 profile array to a program OUTPUT (which
  pins it to the default {2,1,0} layout) also fixes it; inserting
  ``optimization_barrier`` at any/all pipeline points does NOT — the
  corrupt values arise inside producer fusions whose intermediates got
  a transposed {2,0,1} (pixels-minor, samples-major) layout from layout
  assignment, a choice triggered by the packed-storage slice/or graph
  downstream;
* threading is irrelevant (single-threaded + thunk-runtime toggles
  reproduce bit-identically); i16 (unpacked) and f32 storage pass at
  <1e-3 because layout assignment happens to keep default layouts.

Repo-side guard: profile storage defaults to the pipeline dtype
(ops/kernel_config.resolve_abs_store); packed storage runs only when a
caller asks for it.  XLA:GPU is a different code generator: its parity
for packed storage is checked on the card by chip_smoke.py.

Run this after a jax/jaxlib upgrade, and before making packed storage
a default: if all three sections print OK, the upstream CPU bug is
fixed.

Usage:  python scripts/xla_cpu_layout_repro.py
"""

import os
import subprocess
import sys

CHILD = r"""
import os, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))) if "__file__" in dir() else ".")
from gpy_dla_detection_tpu.data.samples import generate_dla_samples
from gpy_dla_detection_tpu.data.spectrum import stack
from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model, synthetic_spectrum)
from gpy_dla_detection_tpu.models.evidence import qmc_log_evidences
from gpy_dla_detection_tpu.models.learned import build_spectrum_model
from gpy_dla_detection_tpu.params import Parameters

abs_dtype = {"i16p": jnp.int32, "i16": jnp.int16, "f32": None}[sys.argv[1]]

params = Parameters(min_lambda=1140.0, max_lambda=1190.0,
                    normalization_min_lambda=1195.0,
                    normalization_max_lambda=1215.0,
                    num_pixels_padded=256, num_dla_samples=64)
learned = synthetic_learned_model(params)
dla_s = generate_dla_samples(params)
devices = np.asarray(jax.devices("cpu")[:8]).reshape(2, 4)
mesh = Mesh(devices, ("spectra", "samples"))
B = 4
spectra = stack([synthetic_spectrum(params, learned, 3.0 + 0.1 * i, seed=i)
                 for i in range(B)])
keys = jax.random.split(jax.random.PRNGKey(0), B)
spec_sh = NamedSharding(mesh, P("spectra"))
samp_sh = NamedSharding(mesh, P("samples"))
repl = NamedSharding(mesh, P())
spectra_d = jax.tree.map(lambda x: jax.device_put(x, spec_sh), spectra)
keys_d = jax.device_put(keys, spec_sh)
d_off = jax.device_put(jnp.asarray(dla_s.offset_samples), samp_sh)
d_lognhi = jax.device_put(jnp.asarray(dla_s.log_nhi_samples), samp_sh)
d_nhi = jax.device_put(jnp.asarray(dla_s.nhi_samples), samp_sh)
learned_d = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), repl), learned)

S = 64
rng = np.random.default_rng(7)
pin = jnp.asarray(rng.integers(0, S, (1, S)), jnp.int32)

def step(learned, spectra, d_off, d_lognhi, d_nhi, keys):
    def one(spec, key):
        model = build_spectrum_model(learned, spec, params)
        r = qmc_log_evidences(model, d_off, d_lognhi, d_nhi, key, 2, params,
                              base_inds_override=pin, abs_dtype=abs_dtype)
        return r.log_evidences, r.sample_log_likelihoods
    return jax.vmap(one)(spectra, keys)

args_sh = (learned_d, spectra_d, d_off, d_lognhi, d_nhi, keys_d)
one_dev = devices.reshape(-1)[0]
args_u = jax.tree.map(lambda x: jax.device_put(np.asarray(x), one_dev), args_sh)
with mesh:
    ev_sh, ll_sh = jax.jit(step)(*args_sh)
    jax.block_until_ready(ev_sh)
ev_u, ll_u = jax.jit(step)(*args_u)
ev_sh, ev_u, ll_sh, ll_u = map(lambda x: np.asarray(x, np.float64),
                               (ev_sh, ev_u, ll_sh, ll_u))
fin = np.isfinite(ll_sh) & np.isfinite(ll_u)
print(f"RESULT ev_delta={np.nanmax(np.abs(ev_sh - ev_u)):.6g} "
      f"ll_delta={np.abs(ll_sh - ll_u)[fin].max():.6g}")
"""


def run(storage: str, extra_flags: str = "") -> float:
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count=8 {extra_flags}".strip(),
    )
    out = subprocess.run(
        [sys.executable, "-c", CHILD, storage],
        env=env, capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    for line in out.stdout.splitlines():
        if line.startswith("RESULT"):
            print(f"  [{storage:4s}] {line}  (flags: {extra_flags or 'default'})")
            return float(line.split("ll_delta=")[1])
    print(out.stdout[-2000:], out.stderr[-2000:])
    raise SystemExit(f"child failed for storage={storage}")


if __name__ == "__main__":
    print("1. forced i16p packed storage, default flags "
          "(the round-3 bug: expect ll_delta O(100) while unfixed upstream)")
    d_bug = run("i16p")
    print("2. forced i16p, --xla_disable_hlo_passes=fusion "
          "(expect clean <1e-2: same HLO, no fusion emitter)")
    d_nofuse = run("i16p", "--xla_disable_hlo_passes=fusion")
    print("3. f32 / i16 storage, default flags (expect clean <1e-2)")
    d_f32 = run("f32")
    d_i16 = run("i16")
    ok = d_nofuse < 1e-2 and d_f32 < 1e-2 and d_i16 < 1e-2
    if d_bug < 1e-2:
        print("UPSTREAM BUG APPEARS FIXED: packed storage is clean on this "
              "jaxlib's CPU backend.")
    print("OK" if ok else "UNEXPECTED: control configurations diverged")
    sys.exit(0 if ok else 1)
