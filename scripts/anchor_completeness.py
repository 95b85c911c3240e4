"""Reference-anchored completeness for the LLS and CIV heads
(VERDICT r4 item 4): run the REFERENCE engine on the same injected
spectra as our accuracy gates and record its recall curve next to ours,
so the weak-absorber rolloff in ACCURACY.json is either certified
physics (curves match) or exposed as a bug (reference detects where we
don't).

* LLS: the reference's LLSGPDR12 configuration — the DLAGP sequential
  QMC engine with the Lyman-limit-break Voigt kernel (reference:
  examples/gp_find_lls.py:102-224, 825-1075) — built directly on the
  synthetic learned model, exactly as tests/test_lls_civ.py's pinned
  conformance test does.  Detection rule identical on both sides:
  P(LLS | D) = 1 - lls_model_posteriors(null_ev, evidences)[0] > 0.5.
* CIV: the reference has no QMC evidence (its civ_gp.py:248-250 left it
  TODO), so the anchor composes the reference's OWN pieces — CIVGP
  set_data/get_interp preprocessing, voigt_civ kernel, and
  log_mvnpdf_low_rank with the K + V covariance (civ_gp.py:158-237) —
  under the same logmeanexp - log(S) estimator our engine uses.  Any
  rolloff discrepancy then isolates our vectorized JAX engine from the
  reference's serial numpy stack.

The reference loop is serial numpy (~minutes/spectrum at production
sample counts on this host), so the anchor runs a subset (default 24
spectra, 2000 samples) drawn with the same injection distributions as
scripts/accuracy_gates.py.  Our engine runs the production path on the
default backend.  Results are merged into ACCURACY.json under
"lls_reference_anchor" / "civ_reference_anchor".

Usage: python scripts/anchor_completeness.py [--n 24] [--num-samples 2000]
           [--out ACCURACY.json]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from gpy_dla_detection_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import numpy as np

LLS_BINS = [(17.8, 18.5), (18.5, 19.0), (19.0, 19.5), (19.5, 20.0), (20.0, 21.5)]
CIV_BINS = [(13.3, 13.6), (13.6, 13.9), (13.9, 14.2), (14.2, 14.5)]


def _curve(bins, values, injected, detected):
    out = {}
    for lo, hi in bins:
        m = injected & (values >= lo) & (values < hi)
        out[f"[{lo},{hi})"] = float(np.mean(detected[m])) if m.any() else None
    return out


def _import_reference():
    """Script-safe variant of tests.reference_oracle.import_reference."""
    ref = "/root/reference"
    if not os.path.isdir(os.path.join(ref, "gpy_dla_detection")):
        raise SystemExit("reference implementation not available")
    if ref not in sys.path:
        sys.path.insert(0, ref)
    import types

    if "emcee" not in sys.modules:
        stub = types.ModuleType("emcee")
        stub.EnsembleSampler = object
        sys.modules["emcee"] = stub


def lls_anchor(n, num_samples, max_lya=2):
    """Both engines on the same n spectra (half injected, logNHI uniform
    in [17.8, 21.5] — the distribution of scripts/accuracy_gates.py)."""
    import jax

    from gpy_dla_detection_tpu.data.spectrum import preprocess
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
    )
    from gpy_dla_detection_tpu.models.lls import (
        generate_lya_samples,
        lls_log_evidences,
        lls_model_posteriors,
    )
    from gpy_dla_detection_tpu.params import Parameters

    # before _import_reference: /root/reference/tests would otherwise
    # shadow the repo's tests package as a namespace package
    from tests.test_pipeline_conformance import _StubDLASamples, _StubPrior

    _import_reference()
    from gpy_dla_detection import voigt_lls
    from gpy_dla_detection.dla_gp import DLAGP as RefDLAGP
    from gpy_dla_detection.set_parameters import Parameters as RefParameters

    class RefLLSGP(RefDLAGP):
        """The LLSGPDR12 configuration (gp_find_lls.py:160-224): the
        DLAGP QMC engine with the Lyman-limit-break Voigt kernel."""

        def this_dla_gp(self, z_lls, nhis):
            mask_ind = ~self.pixel_mask[self.ind_unmasked]
            wavelengths = (
                self.padded_wavelengths
                if self.broadening
                else self.unmasked_wavelengths
            )
            absorption = voigt_lls.voigt_absorption(
                wavelengths, nhi=nhis[0], z_lls=z_lls[0],
                num_lines=self.params.num_lines, broadening=self.broadening,
            )
            for j in range(1, len(z_lls)):
                absorption = absorption * voigt_lls.voigt_absorption(
                    wavelengths, nhi=nhis[j], z_lls=z_lls[j],
                    num_lines=self.params.num_lines,
                    broadening=self.broadening,
                )
            absorption = absorption[mask_ind]
            return (
                self.this_mu * absorption,
                self.this_M * absorption[:, None],
                self.this_omega2 * absorption**2,
            )

    params = Parameters(num_dla_samples=num_samples)
    learned = synthetic_learned_model(params)
    samples = generate_lya_samples(num_samples, prior="garnett")
    rng = np.random.default_rng(7)
    z_qsos = rng.uniform(2.6, 3.6, size=n)
    injected = np.arange(n) % 2 == 1
    log_nhis = rng.uniform(17.8, 21.5, size=n)

    observations = []
    for i in range(n):
        z = float(z_qsos[i])
        dlas = None
        if injected[i]:
            dlas = [(z - float(rng.uniform(0.15, 0.5)), float(log_nhis[i]))]
        observations.append(
            synthetic_observation(
                params, learned, z, seed=100 + i, dlas=dlas,
                with_lls_break=True,
            )
        )

    ref_params = RefParameters(num_dla_samples=num_samples)
    ref = RefLLSGP(
        ref_params,
        _StubPrior(),
        _StubDLASamples(samples, params),
        rest_wavelengths=learned.rest_wavelengths,
        mu=learned.mu,
        M=learned.M,
        log_omega=learned.log_omega,
        log_c_0=float(learned.log_c_0),
        log_tau_0=float(learned.log_tau_0),
        log_beta=float(learned.log_beta),
        prev_tau_0=float(learned.prev_tau_0),
        prev_beta=float(learned.prev_beta),
    )

    p_ours, p_ref = [], []
    t_ours = t_ref = 0.0
    for i, (wl, fx, nv, pm) in enumerate(observations):
        z = float(z_qsos[i])

        t0 = time.time()
        spec = preprocess(wl, fx, nv, pm, z, params)
        null_ev, result = lls_log_evidences(
            learned, spec, samples, jax.random.PRNGKey(i), max_lya, params
        )
        post = lls_model_posteriors(
            float(null_ev), np.asarray(result.log_evidences)
        )
        p_ours.append(1.0 - post[0])
        t_ours += time.time() - t0

        t0 = time.time()
        np.random.seed(0)  # the reference driver's per-spectrum seed
        ref.set_data((wl / (1.0 + z)).copy(), fx.copy(), nv.copy(),
                     pm.copy(), z)
        ref_null = ref.log_model_evidence()
        ref_evs = ref.log_model_evidences(max_lya)
        post_r = lls_model_posteriors(float(ref_null), np.asarray(ref_evs))
        p_ref.append(1.0 - post_r[0])
        t_ref += time.time() - t0
        print(
            f"[lls {i + 1}/{n}] logNHI="
            f"{log_nhis[i]:.2f}{'' if injected[i] else ' (clean)'} "
            f"ours={p_ours[-1]:.3f} ref={p_ref[-1]:.3f}",
            flush=True,
        )

    det_ours = np.asarray(p_ours) > 0.5
    det_ref = np.asarray(p_ref) > 0.5
    disagree = [
        {
            "index": int(i),
            "log_nhi": float(log_nhis[i]) if injected[i] else None,
            "p_ours": float(p_ours[i]),
            "p_ref": float(p_ref[i]),
        }
        for i in range(n)
        if det_ours[i] != det_ref[i]
    ]
    return {
        "n": n,
        "num_samples": num_samples,
        "injected_lognhi_range": [17.8, 21.5],
        "ours": {
            "recall_overall": float(np.mean(det_ours[injected])),
            "completeness_curve": _curve(LLS_BINS, log_nhis, injected, det_ours),
            "false_positive_rate": float(np.mean(det_ours[~injected])),
            "seconds": round(t_ours, 1),
        },
        "reference": {
            "recall_overall": float(np.mean(det_ref[injected])),
            "completeness_curve": _curve(LLS_BINS, log_nhis, injected, det_ref),
            "false_positive_rate": float(np.mean(det_ref[~injected])),
            "seconds": round(t_ref, 1),
        },
        "decision_disagreements": disagree,
        "max_abs_p_delta": float(np.max(np.abs(np.asarray(p_ours) - np.asarray(p_ref)))),
        "reference_config": "LLSGPDR12 semantics (gp_find_lls.py:102-224) "
        "on the synthetic learned model; identical posterior rule both "
        "sides (flat p=0.5 prior)",
    }


def civ_anchor(n, num_samples):
    """Both engines on the same n z~2 spectra (half carry one injected
    doublet, logN uniform in [13.3, 14.5])."""
    from scipy.special import wofz

    from gpy_dla_detection_tpu import constants as C
    from gpy_dla_detection_tpu.data.spectrum import preprocess
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
    )
    from gpy_dla_detection_tpu.models.civ import (
        civ_inference_many,
        civ_model_posterior,
        generate_civ_samples,
    )
    from gpy_dla_detection_tpu.params import CIVParameters

    _import_reference()
    # the reference uses the long-removed np.float alias (voigt_civ.py:162)
    if not hasattr(np, "float"):
        np.float = np.float64
    from gpy_dla_detection.civ_gp import CIVGP as RefCIVGP
    from gpy_dla_detection.civ_set_parameter import (
        CIVParameters as RefCIVParameters,
    )

    params = CIVParameters(num_civ_samples=num_samples)
    learned = synthetic_learned_model(params)
    samples = generate_civ_samples(params)
    rng = np.random.default_rng(11)
    z_qsos = rng.uniform(2.0, 2.3, size=n)
    injected = np.arange(n) % 2 == 1
    log_ns = rng.uniform(13.3, 14.5, size=n)

    def inject_doublet(wl, flux, z_civ, log_n, sig):
        tau = np.zeros_like(wl)
        for l in range(2):
            lam_c = C.CIV_WAVELENGTHS_CM[l] * 1e8 * (1 + z_civ)
            vel = (wl - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
            zz = (vel + 1j * C.CIV_LORENTZIAN_WIDTHS[l]) / (np.sqrt(2) * sig)
            tau += (
                10.0**log_n * C.CIV_LEADING_CONSTANTS[l] * np.real(wofz(zz))
                / (np.sqrt(2 * np.pi) * sig)
            )
        return flux * np.exp(-tau)

    observations, specs = [], []
    for i in range(n):
        z = float(z_qsos[i])
        wl, fx, nv, pm = synthetic_observation(params, learned, z, seed=200 + i)
        if injected[i]:
            z_civ = z - float(rng.uniform(0.05, 0.2))
            sig = float(rng.uniform(1.5e6, 4e6))
            fx = inject_doublet(wl, fx, z_civ, float(log_ns[i]), sig)
        observations.append((wl, fx, nv, pm))
        specs.append(preprocess(wl, fx, nv, pm, z, params))

    t0 = time.time()
    out = civ_inference_many(learned, iter(specs), samples, params)
    t_ours = time.time() - t0
    p_ours = np.array([p for p, _, _ in out])

    ref_params = RefCIVParameters()
    ref = RefCIVGP(
        ref_params,
        rest_wavelengths=learned.rest_wavelengths,
        mu=learned.mu,
        M=learned.M,
    )

    p_ref = []
    t_ref = 0.0
    for i, (wl, fx, nv, pm) in enumerate(observations):
        z = float(z_qsos[i])
        t0 = time.time()
        ref.set_data((wl / (1.0 + z)).copy(), fx.copy(), nv.copy(),
                     pm.copy(), z)
        ref_logmvn = ref.log_mvnpdf_low_rank  # (null_gp.py:308)
        d = ref.v  # K + V covariance: no omega2 term (civ_gp.py:158-183)
        null_ev = ref_logmvn(ref.y, ref.this_mu, ref.this_M, d)
        lo = ref_params.min_z_civ(ref.this_wavelengths, z)
        hi = ref_params.max_z_civ(ref.this_wavelengths, z)
        z_s = lo + (hi - lo) * np.asarray(samples.offset_samples)
        lls = np.empty(num_samples)
        for s in range(num_samples):
            civ_mu, civ_M = ref.this_civ_gp(
                np.array([z_s[s]]),
                np.array([float(samples.nciv_samples[s])]),
                np.array([float(samples.sigma_samples[s])]),
            )
            lls[s] = ref_logmvn(ref.y, civ_mu, civ_M, d)
        # our engine's estimator: logmeanexp with the 1/S Occam factor
        lls = lls - np.log(num_samples)
        m = lls.max()
        civ_ev = m + np.log(np.mean(np.exp(lls - m)))
        p_ref.append(civ_model_posterior(null_ev, civ_ev))
        t_ref += time.time() - t0
        print(
            f"[civ {i + 1}/{n}] logN="
            f"{log_ns[i]:.2f}{'' if injected[i] else ' (clean)'} "
            f"ours={p_ours[i]:.3f} ref={p_ref[-1]:.3f}",
            flush=True,
        )

    det_ours = p_ours > 0.5
    det_ref = np.asarray(p_ref) > 0.5
    disagree = [
        {
            "index": int(i),
            "log_n": float(log_ns[i]) if injected[i] else None,
            "p_ours": float(p_ours[i]),
            "p_ref": float(p_ref[i]),
        }
        for i in range(n)
        if det_ours[i] != det_ref[i]
    ]
    return {
        "n": n,
        "num_samples": num_samples,
        "injected_logn_range": [13.3, 14.5],
        "ours": {
            "recall_overall": float(np.mean(det_ours[injected])),
            "completeness_curve": _curve(CIV_BINS, log_ns, injected, det_ours),
            "false_positive_rate": float(np.mean(det_ours[~injected])),
            "seconds": round(t_ours, 1),
        },
        "reference": {
            "recall_overall": float(np.mean(det_ref[injected])),
            "completeness_curve": _curve(CIV_BINS, log_ns, injected, det_ref),
            "false_positive_rate": float(np.mean(det_ref[~injected])),
            "seconds": round(t_ref, 1),
        },
        "decision_disagreements": disagree,
        "max_abs_p_delta": float(np.max(np.abs(p_ours - np.asarray(p_ref)))),
        "reference_config": "reference CIVGP preprocessing + voigt_civ "
        "kernel + log_mvnpdf_low_rank with K+V covariance "
        "(civ_gp.py:158-237); QMC estimator ours (the reference left it "
        "TODO, civ_gp.py:248-250)",
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--num-samples", type=int, default=2000)
    ap.add_argument("--out", default=os.path.join(REPO, "ACCURACY.json"))
    ap.add_argument("--skip-lls", action="store_true")
    ap.add_argument("--skip-civ", action="store_true")
    ap.add_argument(
        "--cpu", action="store_true",
        help="pin our engine to the host CPU (the reference side is "
        "numpy regardless); default uses the session's default backend",
    )
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_default_device", jax.devices("cpu")[0])

    report = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            report = json.load(f)

    if not args.skip_lls:
        report["lls_reference_anchor"] = lls_anchor(args.n, args.num_samples)
        print("lls_anchor:", json.dumps(report["lls_reference_anchor"]), flush=True)
    if not args.skip_civ:
        report["civ_reference_anchor"] = civ_anchor(args.n, args.num_samples)
        print("civ_anchor:", json.dumps(report["civ_reference_anchor"]), flush=True)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
