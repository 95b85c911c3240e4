"""End-to-end conformance: our pipeline vs the reference implementation
on identical synthetic data (same learned GP, same QMC samples, same
resampling indices), in float64.

The reference is driven through its public array constructors, with a
tiny stub standing in for its .mat-backed sample/prior classes.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gpy_dla_detection_tpu.data.samples import (
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu.data.spectrum import preprocess
from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu.models.evidence import null_log_evidence, qmc_log_evidences
from gpy_dla_detection_tpu.models.learned import build_spectrum_model
from gpy_dla_detection_tpu.models.selection import (
    log_priors_k_dlas,
    log_priors_subdla,
    model_selection,
)
from gpy_dla_detection_tpu.params import Parameters

from .reference_oracle import import_reference

# small but non-trivial problem so the reference's serial loop stays fast
NUM_SAMPLES = 120
MAX_DLAS = 3
Z_QSO = 3.05


class _StubPrior:
    def __init__(self, num_dlas=500, num_quasars=5000):
        self._m, self._n = num_dlas, num_quasars

    def less_ind(self, z_qso):
        return self._m, self._n


class _StubDLASamples:
    def __init__(self, samples, params):
        self._s = samples
        self._params = params

    @property
    def log_nhi_samples(self):
        return self._s.log_nhi_samples

    @property
    def nhi_samples(self):
        return self._s.nhi_samples

    def sample_z_dlas(self, wavelengths, z_qso):
        p = self._params
        lo = p.min_z_dla(wavelengths, z_qso)
        hi = p.max_z_dla(wavelengths, z_qso)
        return lo + (hi - lo) * self._s.offset_samples

    sample_z_lls = sample_z_dlas


@pytest.fixture(scope="module")
def setup():
    import_reference()
    from gpy_dla_detection.dla_gp import DLAGP
    from gpy_dla_detection.set_parameters import Parameters as RefParameters
    from gpy_dla_detection.subdla_gp import SubDLAGP

    params = Parameters(num_dla_samples=NUM_SAMPLES)
    learned = synthetic_learned_model(params)
    dla_samples = generate_dla_samples(params)
    sub_samples = generate_subdla_samples(params)

    wl, flux, nv, mask = synthetic_observation(
        params, learned, Z_QSO, seed=7, dlas=[(2.8, 20.8)]
    )

    ref_params = RefParameters(num_dla_samples=NUM_SAMPLES)
    prior = _StubPrior()

    common = dict(
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
    ref_dla = DLAGP(
        ref_params, prior, _StubDLASamples(dla_samples, params), **common
    )
    ref_sub = SubDLAGP(
        ref_params, prior, _StubDLASamples(sub_samples, params), **common
    )

    rest = wl / (1.0 + Z_QSO)
    np.random.seed(0)
    ref_dla.set_data(rest.copy(), flux.copy(), nv.copy(), mask.copy(), Z_QSO)
    ref_sub.set_data(rest.copy(), flux.copy(), nv.copy(), mask.copy(), Z_QSO)

    ref_null_ev = ref_dla.log_model_evidence()
    ref_dla_evs = ref_dla.log_model_evidences(MAX_DLAS)
    ref_sub_evs = ref_sub.log_model_evidences(1)

    spec = preprocess(wl, flux, nv, mask, Z_QSO, params)
    model = build_spectrum_model(learned.astype(np.float64), spec, params)

    return dict(
        params=params,
        learned=learned,
        dla_samples=dla_samples,
        sub_samples=sub_samples,
        model=model,
        ref_dla=ref_dla,
        ref_sub=ref_sub,
        ref_null_ev=ref_null_ev,
        ref_dla_evs=ref_dla_evs,
        ref_sub_evs=ref_sub_evs,
    )


def test_model_interpolation_matches(setup):
    """mu, M, omega2 after mean-flux suppression match the reference."""
    ref = setup["ref_dla"]
    model = setup["model"]
    mask = np.asarray(model.mask)
    # reference arrays cover only valid pixels; ours are padded+masked
    np.testing.assert_allclose(np.asarray(model.y)[mask][: len(ref.y)], ref.y, rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(model.mu)[mask], ref.this_mu, rtol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(model.M)[mask], ref.this_M, rtol=1e-8, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(model.omega2)[mask], ref.this_omega2, rtol=1e-8
    )


def test_null_evidence_matches(setup):
    got = float(null_log_evidence(setup["model"]))
    np.testing.assert_allclose(got, setup["ref_null_ev"], rtol=1e-9)


def test_search_range_matches(setup):
    ref = setup["ref_dla"]
    p = setup["params"]
    model = setup["model"]
    assert float(model.min_z_dla) == pytest.approx(
        p.min_z_dla(ref.this_wavelengths, Z_QSO), rel=1e-12
    )
    assert float(model.max_z_dla) == pytest.approx(
        p.max_z_dla(ref.this_wavelengths, Z_QSO), rel=1e-12
    )


def test_dla_evidences_match_reference(setup):
    """With the reference's resampling indices forced, every level's
    evidence, per-sample likelihoods, and MAPs must agree."""
    ref = setup["ref_dla"]
    s = setup["dla_samples"]
    result = qmc_log_evidences(
        setup["model"],
        s.offset_samples,
        s.log_nhi_samples,
        s.nhi_samples,
        jax.random.PRNGKey(0),
        MAX_DLAS,
        setup["params"],
        base_inds_override=ref.base_sample_inds,
        abs_dtype=jnp.float32,  # exact storage: this is the oracle check
    )
    np.testing.assert_allclose(
        np.asarray(result.log_evidences), setup["ref_dla_evs"], rtol=1e-7, atol=1e-4
    )
    got_lls = np.asarray(result.sample_log_likelihoods)
    ref_lls = ref.sample_log_likelihoods
    np.testing.assert_allclose(got_lls, ref_lls, rtol=1e-6, atol=1e-4)

    ref_map_z, ref_map_nhi = ref.maximum_a_posteriori()
    np.testing.assert_allclose(
        np.asarray(result.map_z_dlas), ref_map_z, rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(result.map_log_nhis), ref_map_nhi, rtol=1e-10
    )


def test_subdla_evidence_matches_reference(setup):
    s = setup["sub_samples"]
    result = qmc_log_evidences(
        setup["model"],
        s.offset_samples,
        s.log_nhi_samples,
        s.nhi_samples,
        jax.random.PRNGKey(0),
        1,
        setup["params"],
        abs_dtype=jnp.float32,
    )
    np.testing.assert_allclose(
        np.asarray(result.log_evidences), setup["ref_sub_evs"], rtol=1e-7, atol=1e-4
    )


def test_i16_profile_storage_accuracy(setup):
    """int16 fixed-point profile storage (abs_dtype="i16"/"i16p") vs
    exact f32 storage: the stored absorption quantizes once to a
    1/32767 grid (1.5e-5 uniform absolute error) — the level evidences
    and per-sample log likelihoods must stay orders of magnitude inside
    the reference's own acceptance tolerances (2.5 in log evidence
    MATLAB-to-Python, 5e-2 in p_dla; reference: tests/test_model.py:278,
    tests/test_selection.py:437).  bf16 storage was measured here and
    rejected: 0.8 rms per-sample ll noise, +0.3-0.6 evidence bias."""
    ref = setup["ref_dla"]
    s = setup["dla_samples"]
    results = {}
    for name, dt in (
        ("f32", jnp.float32),
        ("i16", jnp.int16),
        ("i16p", jnp.int32),  # packed pairs: exactly the i16 codes
    ):
        results[name] = qmc_log_evidences(
            setup["model"],
            s.offset_samples,
            s.log_nhi_samples,
            s.nhi_samples,
            jax.random.PRNGKey(0),
            MAX_DLAS,
            setup["params"],
            abs_dtype=dt,
            base_inds_override=ref.base_sample_inds,
        )
    ev32 = np.asarray(results["f32"].log_evidences)
    l32 = np.asarray(results["f32"].sample_log_likelihoods)
    for name in ("i16", "i16p"):
        ev16 = np.asarray(results[name].log_evidences)
        assert np.all(np.abs(ev32 - ev16) < 0.02), (name, ev32 - ev16)
        l16 = np.asarray(results[name].sample_log_likelihoods)
        m = np.isfinite(l32)
        assert np.array_equal(m, np.isfinite(l16))
        d = np.abs(l16[m] - l32[m])
        assert np.sqrt(np.mean(d**2)) < 0.02, (name, np.sqrt(np.mean(d**2)))
        # the MAP sample must not move under the quantization
        np.testing.assert_allclose(
            np.asarray(results["f32"].map_z_dlas),
            np.asarray(results[name].map_z_dlas),
            rtol=0, atol=1e-6, equal_nan=True,
        )
    # packed pairs hold exactly the i16 codes; the decoded profiles are
    # equal, so the two quantized modes track each other tightly (not
    # bit-for-bit: XLA fuses the two decode graphs differently)
    np.testing.assert_allclose(
        np.asarray(results["i16"].log_evidences),
        np.asarray(results["i16p"].log_evidences),
        rtol=0, atol=1e-3,
    )


def test_model_selection_matches_reference(setup):
    """Priors + posterior combination vs the reference BayesModelSelect
    math, using the already-computed evidences."""
    from scipy.special import logsumexp

    sub = setup["sub_samples"]
    m, n = _StubPrior().less_ind(Z_QSO)

    lp_dla = log_priors_k_dlas(m, n, MAX_DLAS)
    ref_lp_dla = setup["ref_dla"].log_priors(Z_QSO, MAX_DLAS)
    np.testing.assert_allclose(lp_dla, ref_lp_dla, rtol=1e-12)

    # reference subDLA prior (subdla_gp.py:311-346) via its own class
    ref_sub = setup["ref_sub"]
    ref_sub.dla_samples._Z_lls = sub.Z_lls
    ref_sub.dla_samples._Z_dla = sub.Z_dla
    ref_lp_sub = ref_sub.log_priors(Z_QSO, 1)
    lp_sub = log_priors_subdla(m, n, sub.Z_lls, sub.Z_dla)
    np.testing.assert_allclose(lp_sub, ref_lp_sub, rtol=1e-12)

    sel = model_selection(
        lp_sub,
        lp_dla,
        setup["ref_null_ev"],
        np.asarray(setup["ref_sub_evs"]),
        np.asarray(setup["ref_dla_evs"]),
    )
    # reference combination (bayesian_model_selection.py:75-109)
    log_priors_rest = np.concatenate([ref_lp_sub, ref_lp_dla])
    ref_log_priors = np.concatenate(
        [[np.log(1 - np.exp(logsumexp(log_priors_rest)))], log_priors_rest]
    )
    ref_log_likelihoods = np.concatenate(
        [[setup["ref_null_ev"]], setup["ref_sub_evs"], setup["ref_dla_evs"]]
    )
    ref_log_post = ref_log_likelihoods + ref_log_priors
    ref_post = np.exp(ref_log_post - logsumexp(ref_log_post))

    np.testing.assert_allclose(sel.log_priors, ref_log_priors, rtol=1e-12)
    np.testing.assert_allclose(sel.model_posteriors, ref_post, rtol=1e-10)
    np.testing.assert_allclose(sel.p_dla, ref_post[-MAX_DLAS:].sum(), rtol=1e-10)
