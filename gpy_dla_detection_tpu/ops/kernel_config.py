"""Kernel-variant selection.

Two hot ops have more than one implementation: the Voigt profile
("exact" Weideman+CF blend at every pixel, or "windowed": a cheap far
field plus the exact blend on a 256-px window around each line) and the
storage of the (S, N) absorption profiles (the pipeline dtype, or
16-bit fixed point).  Which one runs is an explicit *static argument*
threaded through the call chain, resolved here from that argument and
from what the code can see (the dtype, the pixel count) — never from
the environment or the platform, so behaviour cannot depend on
jit-cache state, call order or the machine.

Defaults are the plain paths: the exact Voigt and storage in the
pipeline dtype.  The windowed Voigt and the fixed-point storage are
reachable by explicit choice on float32 pipelines.

Environment variables that remain are read once, at import time, and
are not kernel toggles except GPY_DLA_WINDOW_TIER (ops/voigt.py, the
two-tier window evaluation of the windowed variant) and
GPY_DLA_RESAMPLER (models/evidence.py).  Deployment variables —
GPY_DLA_DATA_DIR, GPY_DLA_SPECTRA_DIR, GPY_DLA_NUM_SPECTRA,
GPY_DLA_NUM_PROCESSES, GPY_DLA_COORDINATOR, GPY_DLA_PROCESS_ID — say
where data and peers are.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

# Two-tier window evaluation (ops/voigt._windowed_tau_parts, f32
# windowed path): the 20-term Weideman Horner + full-K CF run only on a
# 96-px strip around each line center (the |z| <= RADIUS core spans
# ~±1.3 px and the K=2 CF is exact to <2e-8 beyond the strip edge at
# |z| >~ 59); the rest of the 256-px window uses the 2-term CF — about
# half the arithmetic of the window stage.  GPY_DLA_WINDOW_TIER=0
# restores the full-window Weideman+CF blend.
WINDOW_TIER: bool = os.environ.get("GPY_DLA_WINDOW_TIER", "1") == "1"

VOIGT_IMPLS = ("exact", "windowed")


def resolve_voigt_impl(impl: str | None, x) -> str:
    """The Voigt strategy that runs for inputs like ``x``.

    None means "exact".  "windowed" is a float32 fast path (its window
    lookups use an f32 line-center estimate); other dtypes — the f64
    reference above all — resolve to "exact".
    """
    if impl is None:
        return "exact"
    if impl not in VOIGT_IMPLS:
        raise ValueError(f"voigt impl must be one of {VOIGT_IMPLS}, got {impl!r}")
    if impl == "windowed" and jnp.result_type(x) != jnp.float32:
        return "exact"
    return impl


# fixed-point scale of 16-bit absorption-profile storage: profiles are
# in [0, 1] by construction, stored as round(a * ABS_I16_SCALE) and
# decoded as x * (1 / ABS_I16_SCALE) — uniform 1.5e-5 absolute error
# at half the memory traffic of f32.  Shared by the encode and decode
# sides (ops/voigt.encode_profile_store / decode_profile_store).
ABS_I16_SCALE = 32767.0

# int32 PACKED i16-pair storage ("i16p"): element j of a packed
# (S, N/2) int32 array holds the fixed-point codes of pixels j (low
# half) and j + N/2 (high half) — contiguous halves, so pack/unpack are
# two static slices and a concat, never an interleave.  Same bytes as
# int16, half the elements for the row gathers of the chained levels.
# Codes are in [0, 32767] so the sign bit of both halves is always
# clear: arithmetic >> 16 and & 0xffff recover them exactly.
ABS_STORES = {"f32": None, "i16": jnp.int16, "i16p": jnp.int32}


def resolve_abs_store(abs_dtype, dtype, num_pixels: int):
    """Storage dtype of the (S, N) profile arrays, or None for "keep the
    pipeline dtype".

    :param abs_dtype: an explicit choice — None (pipeline dtype), a
        dtype, or one of the names in ``ABS_STORES``.
    :param dtype: the pipeline dtype.
    :param num_pixels: N; packed pairs need it even and fall back to
        plain int16 otherwise.
    """
    if isinstance(abs_dtype, str) and abs_dtype in ABS_STORES:
        abs_dtype = ABS_STORES[abs_dtype]
    if abs_dtype is None:
        return None
    abs_dtype = jnp.dtype(abs_dtype)
    if abs_dtype == jnp.int32 and num_pixels % 2:
        abs_dtype = jnp.dtype(jnp.int16)
    return None if abs_dtype == jnp.dtype(dtype) else abs_dtype
