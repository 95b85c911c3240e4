"""Gather-based 1-D linear interpolation usable under jit/vmap.

Replaces the reference's ``scipy.interpolate.interp1d`` objects
(reference: gpy_dla_detection/null_gp.py:66-93) with pure functions:
a direct index computation on uniform grids (the learned models live on
uniform rest-wavelength grids), and a ``searchsorted`` fallback for
arbitrary grids.  Out-of-range queries clamp to the boundary value; the
callers mask those pixels out.
"""

from __future__ import annotations

import jax.numpy as jnp


def interp_uniform(x0, dx, values, xq):
    """Linear interpolation of ``values`` sampled on the uniform grid
    ``x0 + dx * arange(n)`` at query points ``xq``.

    :param values: (n,) or (n, k) grid samples.
    :param xq: (...,) query points.
    :return: (...,) or (..., k).
    """
    n = values.shape[0]
    t = (xq - x0) / dx
    idx = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
    frac = jnp.clip(t - idx, 0.0, 1.0)
    # idx is clipped to [0, n-2] above; clip mode skips the fill-mode
    # out-of-bounds select pass
    lo = jnp.take(values, idx, axis=0, mode="clip")
    hi = jnp.take(values, idx + 1, axis=0, mode="clip")
    if values.ndim == 2:
        frac = frac[..., None]
    return lo * (1.0 - frac) + hi * frac


def chunked_searchsorted(sorted_values, queries, chunk: int = 128):
    """``searchsorted(sorted_values, queries, side="right")`` as a
    two-level vectorized count.

    ``jnp.searchsorted`` lowers to a serialized binary-search gather
    chain; this compares each query against the 128-aligned chunk
    maxima, fetches ONE chunk per query from the tiny (n_chunks, 128)
    table, and counts within.  O(n/128 + 128) comparisons per query,
    all elementwise.

    :param sorted_values: (n,) ascending.
    :param queries: (...,) arbitrary shape.
    :return: (...,) int32 insertion indices in [0, n].
    """
    n = sorted_values.shape[0]
    nc = -(-n // chunk)
    padded = jnp.pad(
        sorted_values, (0, nc * chunk - n), constant_values=jnp.inf
    ).reshape(nc, chunk)
    tops = padded[:, -1]  # (nc,)
    q = queries[..., None]
    c_idx = jnp.clip(
        jnp.sum(q >= tops, axis=-1).astype(jnp.int32), 0, nc - 1
    )
    # mode="clip": c_idx is already clipped in-range; the default fill
    # mode would add an out-of-bounds select pass on the gather.  (A
    # one-hot bf16 matmul over a three-plane split of the table, in
    # place of this gather, miscounted on XLA:GPU.)
    rows = jnp.take(padded, c_idx, axis=0, mode="clip")
    within = jnp.sum(q >= rows, axis=-1).astype(jnp.int32)
    return jnp.minimum(c_idx * chunk + within, n)


def interp(xg, values, xq):
    """Linear interpolation on an arbitrary ascending grid ``xg`` —
    indexed through :func:`chunked_searchsorted` (``jnp.searchsorted``
    is the serialized binary-search chain this module exists to
    avoid)."""
    n = xg.shape[0]
    idx = jnp.clip(chunked_searchsorted(xg, xq) - 1, 0, n - 2)
    x_lo = jnp.take(xg, idx, mode="clip")
    x_hi = jnp.take(xg, idx + 1, mode="clip")
    frac = jnp.clip((xq - x_lo) / (x_hi - x_lo), 0.0, 1.0)
    lo = jnp.take(values, idx, axis=0, mode="clip")
    hi = jnp.take(values, idx + 1, axis=0, mode="clip")
    if values.ndim == 2:
        frac = frac[..., None]
    return lo * (1.0 - frac) + hi * frac
