"""Faddeeva function in plain JAX.

The reference pipeline evaluates the Voigt profile through
``scipy.special.wofz`` (reference: gpy_dla_detection/voigt.py:241-248)
or libcerf's ``voigt()`` (reference: voigt.c:282-292).  Neither runs
inside a jitted XLA program, so we implement ``Re/Im w(z)`` for ``Im z >= 0`` from scratch
with two blended regions, both branch-free and vectorizable:

* ``|z| <= RADIUS``: Weideman (1994) rational approximation with
  ``N_WEIDEMAN`` terms (coefficients precomputed in float64 at import
  time).  Absolute accuracy ~1e-13 in f64.

* ``|z| > RADIUS``: truncated Lentz-style continued fraction
  ``w(z) = i/sqrt(pi) / (z - (1/2)/(z - 1/(z - (3/2)/(z - ...))))``.
  This gives *relative* accuracy in the far damping wings where
  ``Re w ~ y / (sqrt(pi) x^2)`` is tiny but scientifically load-bearing
  (DLA damping wings extend to x ~ 1e3 thermal widths).

Everything is written with real-pair arithmetic (no complex dtypes), so
the whole evaluation is elementwise float work that XLA fuses.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

SQRT_PI = 1.7724538509055160273

# region switch radius |z| and term counts (see accuracy test in
# tests/test_faddeeva.py).  Term counts are dtype-tiered: the f32 path
# (production) uses N=20 / K=5 (1.8e-8 relative at |z|=7, below
# f32 rounding); the f64 path uses N=40 / K=14 (~1e-14).
RADIUS = 7.0
N_WEIDEMAN = 40
N_CONTINUED_FRACTION = 14
N_WEIDEMAN_F32 = 20
N_CONTINUED_FRACTION_F32 = 5  # 1.8e-8 rel at |z|=7, below f32 rounding


def _weideman_coefficients(n: int) -> tuple[np.ndarray, float]:
    """Polynomial coefficients of the Weideman (1994) rational approximation.

    Computed once at import time in float64 via the FFT construction.
    Returns (a, L) with ``a`` ordered highest-power-first for Horner.
    """
    m = 2 * n
    L = np.sqrt(n / np.sqrt(2.0))
    theta = np.pi * np.arange(-m + 1, m) / m
    t = L * np.tan(theta / 2.0)
    f = np.exp(-(t**2)) * (L**2 + t**2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2.0 * m)
    a = a[1 : n + 1][::-1].copy()
    return a, float(L)


_WEIDEMAN_A, _WEIDEMAN_L = _weideman_coefficients(N_WEIDEMAN)
_WEIDEMAN_A32, _WEIDEMAN_L32 = _weideman_coefficients(N_WEIDEMAN_F32)


def _wofz_weideman(x, y):
    """Weideman rational approximation of w(x + iy), real-pair arithmetic."""
    dtype = x.dtype
    coeffs, L_val = (
        (_WEIDEMAN_A32, _WEIDEMAN_L32)
        if dtype == jnp.float32
        else (_WEIDEMAN_A, _WEIDEMAN_L)
    )
    L = jnp.asarray(L_val, dtype)
    a = [jnp.asarray(c, dtype) for c in coeffs]

    # recip of (L - iz) = (L + y) - ix
    dr = L + y
    s = dr * dr + x * x
    inv_s = 1.0 / s

    # Z = (L + iz) / (L - iz)
    zr = ((L - y) * dr - x * x) * inv_s
    zi = (2.0 * L * x) * inv_s

    # Horner evaluation of P(Z) with real pairs
    pr = jnp.full_like(x, a[0])
    pi = jnp.zeros_like(x)
    for c in a[1:]:
        pr, pi = pr * zr - pi * zi + c, pr * zi + pi * zr

    # w = 2 P(Z) / (L - iz)^2 + (1/sqrt(pi)) / (L - iz)
    # (L - iz)^-2 = ((dr^2 - x^2) + 2i dr x) / s^2
    inv2_r = (dr * dr - x * x) * inv_s * inv_s
    inv2_i = 2.0 * dr * x * inv_s * inv_s
    w_re = 2.0 * (pr * inv2_r - pi * inv2_i) + dr * inv_s / SQRT_PI
    w_im = 2.0 * (pr * inv2_i + pi * inv2_r) + x * inv_s / SQRT_PI
    return w_re, w_im


def _wofz_cf(x, y, terms: int | None = None):
    """Truncated continued fraction for w(x + iy), accurate for |z| > ~6.

    Guarded against division blow-ups so that evaluating it *inside* the
    |z| < RADIUS disk yields garbage-but-finite values (the windowed
    Voigt path relies on exact cancellation of those values).

    :param terms: override the dtype-tiered truncation depth (the
        windowed Voigt path uses K=2 in the far wings — relative error
        1.6e-7 at |z|=20, 1e-8 at |z|=32, below f32 rounding — and the
        full K on the near annulus).
    """
    if terms is None:
        terms = (
            N_CONTINUED_FRACTION_F32
            if x.dtype == jnp.float32
            else N_CONTINUED_FRACTION
        )
    eps = jnp.asarray(1e-30, x.dtype)
    # v = z - a_n / v, innermost first, with a_n = n / 2
    vr = x
    vi = y
    for n in range(terms, 0, -1):
        an = n / 2.0
        inv_v2 = an / (vr * vr + vi * vi + eps)
        vr = x - vr * inv_v2
        vi = y + vi * inv_v2
    # w = i / (sqrt(pi) v)
    inv_v2 = 1.0 / (SQRT_PI * (vr * vr + vi * vi + eps))
    return vi * inv_v2, vr * inv_v2


def wofz_parts(x, y):
    """(Re, Im) of the Faddeeva function w(x + iy) for y >= 0.

    Broadcasts over ``x`` and ``y``.  Matches ``scipy.special.wofz`` to
    ~1e-12 relative in float64 over the domain exercised by the Voigt
    kernels (|x| up to 1e5 with 1e-5 < y < 10).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    x, y = jnp.broadcast_arrays(x, y)
    # w(-x + iy) = conj(w(x + iy)): evaluate at |x|, flip Im afterwards
    sign = jnp.sign(x)
    ax = jnp.abs(x)

    inner = ax * ax + y * y <= RADIUS * RADIUS
    # Evaluate both branches everywhere and blend; guard each branch's
    # inputs so the inactive branch cannot generate inf/nan gradients.
    wr_in, wi_in = _wofz_weideman(jnp.where(inner, ax, 0.0), jnp.where(inner, y, 0.0))
    wr_out, wi_out = _wofz_cf(jnp.where(inner, RADIUS + 1.0, ax), jnp.where(inner, 1.0, y))
    w_re = jnp.where(inner, wr_in, wr_out)
    w_im = jnp.where(inner, wi_in, wi_out)
    return w_re, sign * w_im


def voigt_profile(v, sigma, gamma):
    """Normalized Voigt profile in velocity space.

    ``V(v; sigma, gamma) = Re[w((v + i gamma)/(sqrt(2) sigma))] / (sqrt(2 pi) sigma)``
    (reference: gpy_dla_detection/voigt.py:241-248)
    """
    inv = 1.0 / (jnp.sqrt(2.0) * sigma)
    w_re, _ = wofz_parts(v * inv, gamma * inv)
    return w_re * (inv / SQRT_PI)
