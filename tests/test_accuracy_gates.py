"""Hermetic head-accuracy gates (VERDICT r3 item 7, suite-sized).

Scaled-down twins of scripts/accuracy_gates.py (which runs the
full-scale version — 300/200/200 spectra at 10k samples — and writes
ACCURACY.json): measured detection/estimation accuracy over batches of
synthetic spectra with injected absorbers, printed to the test log,
with gates on the detectable regime (zQSO: reference gate
P(|dz|<0.5) > 0.98 — reference: tests/test_zestimation.py:68-70).
"""

import numpy as np
import pytest

slow = pytest.mark.slow


@slow
def test_zqso_batch_accuracy_gate():
    import jax  # noqa: F401

    from gpy_dla_detection_tpu.data.synthetic import synthetic_z_observation
    from gpy_dla_detection_tpu.models.zqso import (
        inference_z_qso_many,
        prepare_z_spectrum,
    )
    from gpy_dla_detection_tpu.params import ZParameters

    params = ZParameters(num_zqso_samples=1200)
    rng = np.random.default_rng(42)
    n = 10
    z_true = rng.uniform(2.3, 4.8, size=n)
    learned, _ = synthetic_z_observation(3.0, seed=0)

    def specs():
        for i, z in enumerate(z_true):
            _, (wl, fx, nv, pm) = synthetic_z_observation(
                float(z), seed=0, obs_seed=10_000 + i
            )
            yield prepare_z_spectrum(wl, fx, nv, pm, params.num_pixels_padded)

    results, _ = inference_z_qso_many(learned, specs(), params)
    dz = np.abs(np.array([r[0] for r in results]) - z_true)
    print(f"zqso gate: n={n} P(|dz|<0.5)={np.mean(dz < 0.5):.3f} "
          f"median={np.median(dz):.4f} worst={dz.max():.4f}")
    assert np.mean(dz < 0.5) == 1.0, dz


@slow
def test_lls_detection_gate():
    import jax

    from gpy_dla_detection_tpu.data.spectrum import preprocess
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
    )
    from gpy_dla_detection_tpu.models.lls import (
        generate_lya_samples,
        lls_inference_many,
        lls_model_posteriors,
    )
    from gpy_dla_detection_tpu.params import Parameters

    params = Parameters()
    learned = synthetic_learned_model(params)
    samples = generate_lya_samples(num_samples=800)
    rng = np.random.default_rng(7)
    n = 12
    z_qsos = rng.uniform(2.6, 3.6, size=n)
    injected = np.arange(n) % 2 == 1
    # strong regime only (full-scale curve in ACCURACY.json covers the
    # rolloff below logNHI 19.5)
    log_nhis = rng.uniform(19.6, 21.5, size=n)

    def specs():
        for i in range(n):
            z = float(z_qsos[i])
            dlas = (
                [(z - float(rng.uniform(0.15, 0.5)), float(log_nhis[i]))]
                if injected[i]
                else None
            )
            wl, fx, nv, pm = synthetic_observation(
                params, learned, z, seed=100 + i, dlas=dlas,
                with_lls_break=True,
            )
            yield preprocess(wl, fx, nv, pm, z, params)

    out = lls_inference_many(
        learned, specs(), samples, jax.random.PRNGKey(0), 2, params
    )
    p = np.array(
        [1.0 - lls_model_posteriors(ne, r.log_evidences)[0] for ne, r in out]
    )
    detected = p > 0.5
    print(f"lls gate: recall={detected[injected].mean():.2f} "
          f"fp={detected[~injected].mean():.2f} p={p.round(3).tolist()}")
    assert detected[injected].all(), p[injected]
    assert not detected[~injected].any(), p[~injected]


@slow
def test_civ_detection_gate():
    from scipy.special import wofz

    from gpy_dla_detection_tpu import constants as C
    from gpy_dla_detection_tpu.data.spectrum import preprocess
    from gpy_dla_detection_tpu.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
    )
    from gpy_dla_detection_tpu.models.civ import (
        civ_inference_many,
        generate_civ_samples,
    )
    from gpy_dla_detection_tpu.params import CIVParameters

    params = CIVParameters(num_civ_samples=800)
    learned = synthetic_learned_model(params)
    samples = generate_civ_samples(params)
    rng = np.random.default_rng(11)
    n = 12
    z_qsos = rng.uniform(2.0, 2.3, size=n)
    injected = np.arange(n) % 2 == 1
    log_ns = rng.uniform(14.2, 14.5, size=n)  # strong regime

    def inject(wl, flux, z_civ, log_n, sig):
        tau = np.zeros_like(wl)
        for l in range(2):
            lam_c = C.CIV_WAVELENGTHS_CM[l] * 1e8 * (1 + z_civ)
            vel = (wl - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
            zz = (vel + 1j * C.CIV_LORENTZIAN_WIDTHS[l]) / (np.sqrt(2) * sig)
            tau += (
                10.0**log_n
                * C.CIV_LEADING_CONSTANTS[l]
                * np.real(wofz(zz))
                / (np.sqrt(2 * np.pi) * sig)
            )
        return flux * np.exp(-tau)

    def specs():
        for i in range(n):
            z = float(z_qsos[i])
            wl, fx, nv, pm = synthetic_observation(
                params, learned, z, seed=200 + i
            )
            if injected[i]:
                fx = inject(
                    wl, fx, z - float(rng.uniform(0.05, 0.2)),
                    float(log_ns[i]), float(rng.uniform(1.5e6, 4e6)),
                )
            yield preprocess(wl, fx, nv, pm, z, params)

    out = civ_inference_many(learned, specs(), samples, params)
    p = np.array([x[0] for x in out])
    detected = p > 0.5
    print(f"civ gate: recall={detected[injected].mean():.2f} "
          f"fp={detected[~injected].mean():.2f} p={p.round(3).tolist()}")
    assert detected[injected].all(), p[injected]
    assert not detected[~injected].any(), p[~injected]
