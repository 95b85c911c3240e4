"""Low-rank multivariate-normal log density (Woodbury / matrix lemma).

The single hot likelihood of the whole pipeline:

    log N(y; mu, M M^T + diag(d))

computed in O(n k^2) via the Woodbury identity with a rank-k capacitance
matrix ``B = I + M^T D^-1 M`` (reference:
gpy_dla_detection/null_gp.py:307-360, log_mvnpdf_low_rank.m:1-33).

Design decisions:

* **masked, fixed-shape**: spectra are padded to a static pixel count;
  invalid pixels enter with ``1/d = 0`` (equivalent to infinite noise)
  and are excluded from the log-determinant and the pixel count.  This
  replaces the reference's per-spectrum dynamic slicing.

* **batched over absorption profiles**: for QMC marginalization the
  sample axis only rescales the data-space quantities elementwise
  (``mu_s = mu * a_s``, ``M_s = M * a_s[:, None]``, ``omega2_s = omega2
  * a_s^2``), so ``batched_log_mvnpdf`` never materializes the
  (S, N, k) tensor: the capacitance matrices for all samples come from
  one (S, N) x (N, k^2) matmul against the precomputed outer-product
  basis of M — one matrix product in place of the 10,000 likelihood
  evaluations the reference runs in a serial Python loop (reference:
  dla_gp.py:128-159).

* every float32 product runs at ``Precision.HIGHEST``: a default-
  precision product may run in TF32 (about three decimal digits) on
  the GPU, which the evidences cannot afford.

* the k x k Cholesky factorizations are batched over samples.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .voigt import decode_profile_store

LOG_2PI = 1.8378770664093453
HIGHEST = jax.lax.Precision.HIGHEST


def _masked_inputs(y, mu, d, mask):
    delta = jnp.where(mask, y - mu, 0.0)
    d_safe = jnp.where(mask, d, 1.0)
    d_inv = jnp.where(mask, 1.0 / d_safe, 0.0)
    log_d = jnp.where(mask, jnp.log(d_safe), 0.0)
    return delta, d_inv, log_d


def log_mvnpdf_low_rank(y, mu, M, d, mask=None):
    """log N(y; mu, M M^T + diag(d)) over valid pixels.

    :param y, mu, d: (..., N)
    :param M: (..., N, k)
    :param mask: (..., N) bool, True = valid pixel.  None = all valid.
    :return: (...,) log density.
    """
    if mask is None:
        mask = jnp.ones(y.shape, dtype=bool)
    delta, d_inv, log_d = _masked_inputs(y, mu, d, mask)

    k = M.shape[-1]
    D_inv_M = M * d_inv[..., None]  # (..., N, k)
    B = jnp.eye(k, dtype=y.dtype) + jnp.einsum(
        "...ni,...nj->...ij", M, D_inv_M, precision=HIGHEST
    )
    L = jnp.linalg.cholesky(B)
    # M^T D^-1 delta
    u = jnp.einsum("...ni,...n->...i", M, d_inv * delta, precision=HIGHEST)
    t = jax.scipy.linalg.solve_triangular(L, u[..., None], lower=True)[..., 0]

    quad = jnp.sum(delta * delta * d_inv, axis=-1) - jnp.sum(t * t, axis=-1)
    log_det = jnp.sum(log_d, axis=-1) + 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
    )
    n = jnp.sum(mask, axis=-1)
    return -0.5 * (quad + log_det + n * LOG_2PI)


def log_mvnpdf_iid(y, mu, d, mask=None):
    """log N(y; mu, diag(d)) over valid pixels
    (reference: gpy_dla_detection/zqso_gp.py:252-278)."""
    if mask is None:
        mask = jnp.ones(jnp.asarray(y).shape, dtype=bool)
    delta, d_inv, log_d = _masked_inputs(y, mu, d, mask)
    quad = jnp.sum(delta * delta * d_inv, axis=-1)
    n = jnp.sum(mask, axis=-1)
    return -0.5 * (quad + jnp.sum(log_d, axis=-1) + n * LOG_2PI)


def pair_basis(M):
    """Precompute the outer-product basis ``P[n, i*k+j] = M[n,i] M[n,j]``
    used to form all per-sample capacitance matrices with one matmul."""
    N, k = M.shape
    return (M[:, :, None] * M[:, None, :]).reshape(N, k * k)


def batched_quad_logdet(B, u):
    """(u^T B^-1 u, log det B) for a batch of small SPD matrices.

    Unrolled Cholesky with the forward substitution fused in, expressed
    as k rank-1 elementwise updates over the sample axis, in place of a
    batched ``cholesky``/``triangular_solve`` that would run k x k
    solver loops per sample.

    :param B: (S, k, k) SPD.
    :param u: (S, k).
    :return: (quad (S,), logdet (S,))
    """
    S, k, _ = B.shape
    A = B
    quad = jnp.zeros((S,), B.dtype)
    logdet = jnp.zeros((S,), B.dtype)
    row_idx = jnp.arange(k)
    for j in range(k):
        dj = A[:, j, j]
        logdet = logdet + jnp.log(dj)
        inv_sqrt = jax.lax.rsqrt(dj)
        col = A[:, :, j] * inv_sqrt[:, None]  # (S, k): L[:, j] scaled
        col = jnp.where(row_idx >= j, col, 0.0)
        tj = u[:, j] * inv_sqrt
        quad = quad + tj * tj
        u = u - tj[:, None] * col
        if j < k - 1:
            A = A - col[:, :, None] * col[:, None, :]
    return quad, logdet


def batched_log_mvnpdf(y, mu, M, omega2, v, mask, absorption, M_pair=None):
    """log N(y; mu * a_s, (M a_s)(M a_s)^T + diag(omega2 a_s^2 + v)) for a
    batch of absorption profiles ``a_s``.

    :param y, mu, omega2, v: (N,) spectrum-level arrays.
    :param M: (N, k).
    :param mask: (N,) bool.
    :param absorption: (S, N) absorption profiles, in the spectrum dtype
        or in a fixed-point storage format (ops/kernel_config.py), which
        is decoded on entry.
    :param M_pair: optional precomputed ``pair_basis(M)``.
    :return: (S,) log densities.
    """
    k = M.shape[-1]
    if M_pair is None:
        M_pair = pair_basis(M)

    a = jnp.where(mask, decode_profile_store(absorption, y.dtype), 1.0)
    d = omega2 * a * a + v
    d_safe = jnp.where(mask, d, 1.0)
    d_inv = jnp.where(mask, 1.0 / d_safe, 0.0)  # (S, N)

    delta = jnp.where(mask, y - mu * a, 0.0)  # (S, N)

    with jax.named_scope("capacitance"):
        # B_s = I + M^T diag(a_s^2 / d_s) M
        w = a * a * d_inv  # (S, N)
        B = jnp.eye(k, dtype=y.dtype) + jnp.matmul(
            w, M_pair, precision=HIGHEST
        ).reshape(-1, k, k)

        # u_s = (M a_s)^T D^-1 delta_s
        r = a * delta * d_inv  # (S, N)
        u = jnp.matmul(r, M, precision=HIGHEST)  # (S, k)

    with jax.named_scope("quad_logdet"):
        corr, log_det_B = batched_quad_logdet(B, u)

    quad = jnp.sum(delta * delta * d_inv, axis=-1) - corr
    log_det = jnp.sum(jnp.where(mask, jnp.log(d_safe), 0.0), axis=-1) + log_det_B
    n = jnp.sum(mask)
    return -0.5 * (quad + log_det + n * LOG_2PI)
