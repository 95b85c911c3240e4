"""Batched, mesh-sharded Bayesian model selection over many spectra.

The reference processes its ~160k-spectrum catalog as a serial Python
loop per spectrum plus SLURM job arrays across machines (reference:
run_bayes_select.py:141, slurm/submit_gp_find_lls.sh:7-13).  Here the
spectra axis is the data-parallel axis of a ``jax.sharding.Mesh``: the
per-spectrum evidence computation is vmapped over a batch whose leading
axis is sharded across devices, the learned model and QMC samples are
replicated, and the only communication is the implicit gather of
per-spectrum results.

On meshes with more than one device the batch runs under
``jax.shard_map`` rather than GSPMD auto-partitioning: every shard is
an independent single-device program, the same one a single device
runs, and no collective appears anywhere in the hot loop (the
per-spectrum work is embarrassingly parallel by construction).
"""

from __future__ import annotations

import functools
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data.catalog import PriorCatalog
from ..data.samples import DLASamples, SubDLASamples
from ..data.spectrum import Spectrum, stack
from ..models.evidence import null_log_evidence, qmc_log_evidences
from ..ops.voigt import unit_lyman_optical_depth
from ..models.learned import LearnedModel, build_spectrum_model
from ..models.pipeline import EvidenceOutputs, SpectrumResult
from ..models.selection import (
    log_priors_k_dlas,
    log_priors_subdla,
    model_selection,
)
from ..params import Parameters


def make_spectra_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices; axis name 'spectra'."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, ("spectra",))


def device_put_inputs(
    learned: LearnedModel,
    dla_samples: DLASamples,
    subdla_samples: SubDLASamples,
    dtype=jnp.float32,
    mesh: Mesh | None = None,
):
    """Commit the batch-invariant inputs (learned model + QMC samples)
    to device memory once, so per-batch dispatches don't re-transfer
    them.

    When the DLA and subDLA offset arrays are equal, both sample sets
    share ONE device buffer — ``batch_evidences`` detects the shared
    unit-tau fast path by identity, with no device->host readback.

    :return: (learned, dla_samples, subdla_samples) with array fields
        as committed device arrays.
    """
    sharding = (
        NamedSharding(mesh, P()) if mesh is not None and mesh.devices.size > 1
        else None
    )

    def put(x):
        arr = jnp.asarray(np.asarray(x), dtype)
        return jax.device_put(arr, sharding) if sharding is not None else (
            jax.device_put(arr)
        )

    learned = jax.tree.map(put, learned)
    shared_offsets = np.array_equal(
        np.asarray(dla_samples.offset_samples),
        np.asarray(subdla_samples.offset_samples),
    )
    dla_off = put(dla_samples.offset_samples)
    sub_off = dla_off if shared_offsets else put(subdla_samples.offset_samples)
    dla_samples = dla_samples._replace(
        offset_samples=dla_off,
        log_nhi_samples=put(dla_samples.log_nhi_samples),
        nhi_samples=put(dla_samples.nhi_samples),
    )
    subdla_samples = subdla_samples._replace(
        offset_samples=sub_off,
        log_nhi_samples=put(subdla_samples.log_nhi_samples),
        nhi_samples=put(subdla_samples.nhi_samples),
    )
    return learned, dla_samples, subdla_samples


def _evidences_fn(
    params: Parameters,
    max_dlas: int,
    voigt_impl=None,
    abs_dtype=None,
    share_unit_tau: bool = False,
):
    """The vmapped per-batch evidence computation (pure function of the
    array arguments; the other arguments are static).

    :param voigt_impl, abs_dtype: static kernel-variant choices threaded
        to models.evidence (None = the plain paths; see
        ops/kernel_config.py).
    :param share_unit_tau: set when the DLA and subDLA offset samples
        are bit-identical, as in the reference's sample files
        (reference: multi_dlas/set_lls_parameters.m:22,59): the
        per-unit-nhi Lyman optical depth is then computed once per
        spectrum and reused by both marginalizations, halving the
        Faddeeva work of the pipeline."""

    def batched(
        learned,
        specs,
        dla_offsets,
        dla_log_nhi,
        dla_nhi,
        sub_offsets,
        sub_log_nhi,
        sub_nhi,
        keys,
    ):
        def one(spec, key):
            model = build_spectrum_model(learned, spec, params)
            k_dla, k_sub = jax.random.split(key)
            unit_tau = None
            if share_unit_tau:
                z_samples = (
                    model.min_z_dla
                    + (model.max_z_dla - model.min_z_dla) * dla_offsets
                )
                with jax.named_scope("absorption"):
                    unit_tau = unit_lyman_optical_depth(
                        model.padded_wavelengths,
                        z_samples,
                        params.num_lines,
                        impl=voigt_impl,
                    )
            qmc = partial(
                qmc_log_evidences,
                params=params,
                voigt_impl=voigt_impl,
                unit_tau=unit_tau,
                abs_dtype=abs_dtype,
            )
            return EvidenceOutputs(
                log_evidence_null=null_log_evidence(model),
                dla=qmc(
                    model, dla_offsets, dla_log_nhi, dla_nhi, k_dla,
                    max_k=max_dlas,
                ),
                subdla=qmc(
                    model, sub_offsets, sub_log_nhi, sub_nhi, k_sub, max_k=1
                ),
            )

        return jax.vmap(one)(specs, keys)

    return batched


@partial(
    jax.jit,
    static_argnames=(
        "params",
        "max_dlas",
        "voigt_impl",
        "abs_dtype",
        "share_unit_tau",
    ),
)
def _batched_evidences(
    learned: LearnedModel,
    specs: Spectrum,
    dla_offsets,
    dla_log_nhi,
    dla_nhi,
    sub_offsets,
    sub_log_nhi,
    sub_nhi,
    keys,
    params: Parameters,
    max_dlas: int,
    voigt_impl=None,
    abs_dtype=None,
    share_unit_tau: bool = False,
) -> EvidenceOutputs:
    return _evidences_fn(params, max_dlas, voigt_impl, abs_dtype, share_unit_tau)(
        learned,
        specs,
        dla_offsets,
        dla_log_nhi,
        dla_nhi,
        sub_offsets,
        sub_log_nhi,
        sub_nhi,
        keys,
    )


@functools.lru_cache(maxsize=32)
def _sharded_evidences(
    mesh: Mesh,
    params: Parameters,
    max_dlas: int,
    voigt_impl=None,
    abs_dtype=None,
    share_unit_tau: bool = False,
):
    """Compile (and cache) the shard-mapped batch program for a mesh.

    The batch (specs, keys) is split over the 'spectra' axis; the
    learned model and QMC samples are replicated.  Each shard traces as
    a single-device program.
    """
    fn = _evidences_fn(params, max_dlas, voigt_impl, abs_dtype, share_unit_tau)
    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P("spectra"), P(), P(), P(), P(), P(), P(), P("spectra")),
        out_specs=P("spectra"),
        check_vma=False,
    )
    return jax.jit(mapped)


def _shard_batch(specs: Spectrum, keys, mesh: Mesh):
    """Place the batch with its leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P("spectra"))
    specs = jax.tree.map(lambda x: jax.device_put(x, sharding), specs)
    keys = jax.device_put(keys, sharding)
    return specs, keys


def batch_evidences(
    learned: LearnedModel,
    specs: Spectrum,
    dla_samples: DLASamples,
    subdla_samples: SubDLASamples,
    keys,
    params: Parameters,
    max_dlas: int = 4,
    mesh: Mesh | None = None,
    dtype=None,
    voigt_impl=None,
    abs_dtype=None,
) -> EvidenceOutputs:
    """Evidences for a batch of spectra (leading axis), optionally
    sharded over a device mesh.

    :param voigt_impl, abs_dtype: static kernel-variant choices (None =
        the plain paths; see ops/kernel_config.py).
    """
    if dtype is not None:
        from ..data.spectrum import astype

        specs = astype(specs, dtype)
        learned = learned.astype(dtype)
    else:
        # dtype=None means "inputs are already consistently typed" (the
        # device_put_inputs configuration); mixing a committed-f32 model
        # with f64 spectra silently degrades the evidences
        spec_dt = jnp.result_type(specs.flux)
        learned_dt = jnp.result_type(learned.mu)
        if spec_dt != learned_dt:
            raise TypeError(
                f"spectra are {spec_dt} but the learned model is "
                f"{learned_dt}; pass dtype= or commit both with "
                "device_put_inputs and cast the spectra to match"
            )

    # the DLA and subDLA sample sets share their redshift offsets
    # (reference: multi_dlas/set_lls_parameters.m:22,59), so the
    # expensive Faddeeva factor can be computed once for both models.
    # Device-committed inputs (device_put_inputs) are detected by buffer
    # identity — comparing them elementwise would force a device->host
    # readback per batch.
    d_off, s_off = dla_samples.offset_samples, subdla_samples.offset_samples
    share_unit_tau = d_off is s_off or (
        isinstance(d_off, np.ndarray)
        and isinstance(s_off, np.ndarray)
        and np.array_equal(d_off, s_off)
    )

    cast = (lambda x: jnp.asarray(x, dtype)) if dtype is not None else jnp.asarray
    args = (
        learned,
        specs,
        cast(dla_samples.offset_samples),
        cast(dla_samples.log_nhi_samples),
        cast(dla_samples.nhi_samples),
        cast(subdla_samples.offset_samples),
        cast(subdla_samples.log_nhi_samples),
        cast(subdla_samples.nhi_samples),
        keys,
    )

    if mesh is not None and mesh.devices.size > 1:
        specs, keys = _shard_batch(specs, keys, mesh)
        args = args[:1] + (specs,) + args[2:8] + (keys,)
        return _sharded_evidences(
            mesh, params, max_dlas, voigt_impl, abs_dtype, share_unit_tau
        )(*args)

    if mesh is not None:
        specs, keys = _shard_batch(specs, keys, mesh)
        args = args[:1] + (specs,) + args[2:8] + (keys,)
    return _batched_evidences(
        *args,
        params=params,
        max_dlas=max_dlas,
        voigt_impl=voigt_impl,
        abs_dtype=abs_dtype,
        share_unit_tau=share_unit_tau,
    )


class TransportBatch(NamedTuple):
    """One dispatched batch's outputs packed for the device->host
    readback, which halves the bytes the survey driver copies back per
    batch: the two large arrays ride compressed:

    * per-sample log-likelihoods as float16 CENTERED on their
      per-(spectrum, level) max (stored separately in f32): centered
      values are <= 0 and the analysis consumes them through
      ``exp(ll - max)``, so the f16 absolute error (~5e-4 x |centered|,
      i.e. ~0.01 at the -20-scale values that matter) is below the
      profile-quantization noise already present;
    * resampling indices as uint16 (LOSSLESS for sample counts
      <= 65535; the production count is 10,000).

    ~10.2 MB -> ~5.2 MB per 32-spectrum batch.  ``finalize_batch``
    decodes back to f32/int32 numpy; evidences, MAP chains and
    model posteriors are bit-identical to the raw transport.

    Sentinel semantics: NaN (invalid sample) round-trips exactly, but a
    ``-inf`` log-likelihood decodes as the finite floor ``max - 60000``
    (the f16 clamp).  ``exp(ll - max)`` — the only way the pipeline and
    the CDDF analysis consume these arrays — is 0.0 either way; only a
    consumer that tests ``ll == -inf`` on the raw catalog arrays would
    see the difference (nothing in this repo or the reference's
    analysis does — reference: CDDF_analysis/calc_cddf.py:407-476).
    """

    log_evidence_null: jnp.ndarray  # (B,)
    dla_log_evidences: jnp.ndarray  # (B, K)
    sub_log_evidences: jnp.ndarray  # (B, 1)
    dla_sll_centered: jnp.ndarray  # (B, S, K) f16, NaN where invalid
    dla_sll_max: jnp.ndarray  # (B, K) f32
    sub_sll_centered: jnp.ndarray  # (B, S, 1) f16
    sub_sll_max: jnp.ndarray  # (B, 1) f32
    base_sample_inds: jnp.ndarray  # (B, K-1, S) uint16
    map_z_dlas: jnp.ndarray  # (B, K, K)
    map_log_nhis: jnp.ndarray  # (B, K, K)


@functools.partial(jax.jit, static_argnames=("with_sample_lls",))
def _pack_transport(
    out: EvidenceOutputs, with_sample_lls: bool = True
) -> TransportBatch:
    def pack_sll(sll):
        m = jnp.nanmax(sll, axis=1, keepdims=True)  # (B, 1, K)
        m = jnp.where(jnp.isfinite(m), m, jnp.zeros_like(m))
        # clamp so deeply-underflowed values stay finite in f16
        # (f16 min normal magnitude bound 65504); NaN passes through
        centered = jnp.clip(sll - m, -60000.0, 0.0)
        return centered.astype(jnp.float16), m[:, 0, :].astype(jnp.float32)

    if not with_sample_lls:
        # catalog-lite: the per-sample arrays (~160 KB/spectrum) never
        # leave the device; evidences/MAPs/posteriors are untouched.
        # Zero-width placeholders keep the pytree structure.
        B, K = out.dla.log_evidences.shape
        return TransportBatch(
            log_evidence_null=out.log_evidence_null,
            dla_log_evidences=out.dla.log_evidences,
            sub_log_evidences=out.subdla.log_evidences,
            dla_sll_centered=jnp.zeros((B, 0, K), jnp.float16),
            dla_sll_max=jnp.zeros((B, K), jnp.float32),
            sub_sll_centered=jnp.zeros((B, 0, 1), jnp.float16),
            sub_sll_max=jnp.zeros((B, 1), jnp.float32),
            base_sample_inds=jnp.zeros((B, K - 1, 0), jnp.uint16),
            map_z_dlas=out.dla.map_z_dlas,
            map_log_nhis=out.dla.map_log_nhis,
        )

    dla_c, dla_m = pack_sll(out.dla.sample_log_likelihoods)
    sub_c, sub_m = pack_sll(out.subdla.sample_log_likelihoods)
    return TransportBatch(
        log_evidence_null=out.log_evidence_null,
        dla_log_evidences=out.dla.log_evidences,
        sub_log_evidences=out.subdla.log_evidences,
        dla_sll_centered=dla_c,
        dla_sll_max=dla_m,
        sub_sll_centered=sub_c,
        sub_sll_max=sub_m,
        base_sample_inds=out.dla.base_sample_inds.astype(jnp.uint16),
        map_z_dlas=out.dla.map_z_dlas,
        map_log_nhis=out.dla.map_log_nhis,
    )


def dispatch_batch(
    learned: LearnedModel,
    spectra: list[Spectrum],
    dla_samples: DLASamples,
    subdla_samples: SubDLASamples,
    params: Parameters,
    key,
    max_dlas: int = 4,
    mesh: Mesh | None = None,
    dtype=None,
    voigt_impl=None,
    abs_dtype=None,
    compact: bool | None = None,
    with_sample_lls: bool = True,
) -> EvidenceOutputs | TransportBatch:
    """Enqueue one batch's evidence computation and return the device
    outputs WITHOUT materializing them — jax dispatch is asynchronous,
    so the caller can overlap the previous batch's host-side
    finalization (device->host readback + model selection) with this
    batch's device compute.  Pads the batch to a multiple of the mesh
    size (``finalize_batch`` drops the padding).

    :param compact: pack the outputs for the readback (TransportBatch —
        halves the device->host bytes of the survey driver).  None
        = auto: on for the f32 production pipeline when the sample
        count fits uint16, off for f64 conformance runs.
    :param with_sample_lls: False = catalog-lite — the per-sample
        log-likelihood arrays and resampling indices never leave the
        device (evidences, MAPs and model posteriors are unaffected);
        the written catalog then omits ``sample_log_likelihoods_*`` and
        ``base_sample_inds``.  For surveys that don't feed the CDDF
        analysis (which needs those arrays —
        reference: CDDF_analysis/calc_cddf.py:407-476)."""
    B = len(spectra)
    n_dev = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
    n_pad = (-B) % n_dev
    padded = spectra + [spectra[-1]] * n_pad

    specs = stack(padded)
    keys = jax.random.split(key, len(padded))
    out = batch_evidences(
        learned,
        specs,
        dla_samples,
        subdla_samples,
        keys,
        params,
        max_dlas,
        mesh,
        dtype=dtype,
        voigt_impl=voigt_impl,
        abs_dtype=abs_dtype,
    )
    if not with_sample_lls:
        # lite mode drops the only dtype-sensitive arrays, so it packs
        # regardless of pipeline dtype or sample count
        return _pack_transport(out, with_sample_lls=False)
    if compact is None:
        compact = (
            jnp.result_type(out.log_evidence_null) == jnp.float32
            and params.num_dla_samples <= 65535
        )
    elif compact and params.num_dla_samples > 65535:
        # forced compact would silently wrap the uint16 resampling
        # indices and corrupt the catalog
        raise ValueError(
            "compact transport stores resampling indices as uint16; "
            f"num_dla_samples={params.num_dla_samples} > 65535 does not fit"
        )
    return _pack_transport(out) if compact else out


def finalize_batch(
    out: EvidenceOutputs | TransportBatch,
    spectra: list[Spectrum],
    subdla_samples: SubDLASamples,
    prior: PriorCatalog,
    max_dlas: int = 4,
) -> list[SpectrumResult]:
    """Materialize one dispatched batch and run the host-side model
    selection (the second half of :func:`process_batch`)."""
    B = len(spectra)
    # materialize every output ONCE per batch: slicing a device array
    # per spectrum would issue a separate small device->host transfer
    # each time.  Start all copies asynchronously first so the per-array
    # latencies overlap instead of summing.
    for leaf in jax.tree.leaves(out):
        try:
            leaf.copy_to_host_async()
        except AttributeError:
            pass
    if isinstance(out, TransportBatch):
        null_ev = np.asarray(out.log_evidence_null)
        dla_ev = np.asarray(out.dla_log_evidences)
        sub_ev = np.asarray(out.sub_log_evidences)
        if out.dla_sll_centered.shape[1] == 0:
            # catalog-lite transport (dispatch_batch with_sample_lls=
            # False): the per-sample arrays never left the device
            dla_sll = sub_sll = base_inds = None
        else:
            # decode the compact transport (see TransportBatch)
            dla_sll = np.asarray(
                out.dla_sll_centered, np.float32
            ) + np.asarray(out.dla_sll_max)[:, None, :]
            sub_sll = np.asarray(
                out.sub_sll_centered, np.float32
            ) + np.asarray(out.sub_sll_max)[:, None, :]
            base_inds = np.asarray(out.base_sample_inds, np.int32)
        map_z = np.asarray(out.map_z_dlas)
        map_lognhi = np.asarray(out.map_log_nhis)
    else:
        null_ev = np.asarray(out.log_evidence_null)
        dla_ev = np.asarray(out.dla.log_evidences)
        sub_ev = np.asarray(out.subdla.log_evidences)
        dla_sll = np.asarray(out.dla.sample_log_likelihoods)
        sub_sll = np.asarray(out.subdla.sample_log_likelihoods)
        base_inds = np.asarray(out.dla.base_sample_inds)
        map_z = np.asarray(out.dla.map_z_dlas)
        map_lognhi = np.asarray(out.dla.map_log_nhis)
    results = []
    for i in range(B):
        num_dlas, num_quasars = prior.less_ind(float(spectra[i].z_qso))
        lp_dla = log_priors_k_dlas(num_dlas, num_quasars, max_dlas)
        lp_sub = log_priors_subdla(
            num_dlas, num_quasars, subdla_samples.Z_lls, subdla_samples.Z_dla
        )
        sel = model_selection(
            lp_sub, lp_dla, null_ev[i], sub_ev[i], dla_ev[i]
        )
        results.append(
            SpectrumResult(
                selection=sel,
                log_evidence_null=float(null_ev[i]),
                log_evidences_dla=dla_ev[i],
                log_evidence_subdla=float(sub_ev[i][0]),
                sample_log_likelihoods_dla=(
                    dla_sll[i] if dla_sll is not None else None
                ),
                sample_log_likelihoods_subdla=(
                    sub_sll[i, :, 0] if sub_sll is not None else None
                ),
                base_sample_inds=(
                    base_inds[i] if base_inds is not None else None
                ),
                map_z_dlas=map_z[i],
                map_log_nhis=map_lognhi[i],
                min_z_dla=float(spectra[i].min_z_dla),
                max_z_dla=float(spectra[i].max_z_dla),
                p_dla=sel.p_dla,
                p_no_dla=sel.p_no_dla,
            )
        )
    return results


def process_batch(
    learned: LearnedModel,
    spectra: list[Spectrum],
    dla_samples: DLASamples,
    subdla_samples: SubDLASamples,
    prior: PriorCatalog,
    params: Parameters,
    key,
    max_dlas: int = 4,
    mesh: Mesh | None = None,
    dtype=None,
    voigt_impl=None,
    abs_dtype=None,
) -> list[SpectrumResult]:
    """Full model selection for a list of spectra: dispatch + finalize
    in one call (drivers that pipeline batches use the two halves
    directly)."""
    out = dispatch_batch(
        learned, spectra, dla_samples, subdla_samples, params, key,
        max_dlas, mesh, dtype=dtype, voigt_impl=voigt_impl,
        abs_dtype=abs_dtype,
    )
    return finalize_batch(out, spectra, subdla_samples, prior, max_dlas)
