"""Batched linear-algebra / special-function primitives for the DPMM sampler.

Building blocks used by the conjugate-prior layer:

* ``log_multivariate_gamma`` -- multivariate log-gamma (reference:
  ``src/utils.jl:66-72``), vectorized over a batch of arguments.
* ``sample_wishart_precision`` -- Bartlett-decomposition sampler for the
  precision matrix of a Normal-Inverse-Wishart posterior.  The reference
  samples ``Sigma ~ InverseWishart(nu, nu*Psi)`` and then inverts
  (``src/priors/niw.jl:34-40``); here we sample the *precision*
  ``P = Sigma^-1 ~ Wishart(nu, (nu*Psi)^-1)`` directly via the Bartlett
  decomposition so no explicit matrix inverse of a random matrix is needed,
  only triangular solves (batched).
* masked/batched Cholesky helpers that stay finite on inactive cluster slots.

All functions are written *batched natively* (leading batch dims, no Python
loops) so they jit into a handful of fused XLA ops.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

LOG_PI = math.log(math.pi)
LOG_2PI = math.log(2.0 * math.pi)


def log_multivariate_gamma(a: jax.Array, dim: int) -> jax.Array:
    """Multivariate log-gamma ``log Gamma_D(a)``, batched over ``a``.

    ``log Gamma_D(a) = D(D-1)/4 * log(pi) + sum_{d=1}^{D} lgamma(a + (1-d)/2)``
    (reference: ``src/utils.jl:66-72``).
    """
    a = jnp.asarray(a)
    d = jnp.arange(1, dim + 1, dtype=a.dtype)  # [D]
    terms = gammaln(a[..., None] + (1.0 - d) / 2.0)
    return dim * (dim - 1) / 4.0 * LOG_PI + jnp.sum(terms, axis=-1)


def masked_cholesky(mat: jax.Array, mask: jax.Array) -> jax.Array:
    """Cholesky of a batch of SPD matrices, substituting identity where
    ``mask`` is False so inactive cluster slots never produce NaNs.

    mat:  [..., D, D]
    mask: [...] boolean
    """
    d = mat.shape[-1]
    eye = jnp.eye(d, dtype=mat.dtype)
    safe = jnp.where(mask[..., None, None], mat, eye)
    return jnp.linalg.cholesky(safe)


def chol_logdet(chol: jax.Array) -> jax.Array:
    """log|A| given the lower Cholesky factor of A.  [..., D, D] -> [...]."""
    diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def _batched_tri_solve(l: jax.Array, b: jax.Array, *, trans: bool) -> jax.Array:
    """Solve ``L x = b`` (or ``L^T x = b``) for lower-triangular L, batched.

    l: [..., D, D] lower triangular; b: [..., D, M].
    """
    return jax.lax.linalg.triangular_solve(
        l, b, left_side=True, lower=True, transpose_a=trans
    )


def sample_wishart_precision(
    key: jax.Array, nu: jax.Array, psi: jax.Array, mask: jax.Array,
    chol_psi: jax.Array = None,
):
    """Sample ``P ~ Wishart(nu, (nu*Psi)^-1)`` batched, via Bartlett.

    Equivalent to sampling ``Sigma ~ InverseWishart(nu, nu*Psi)`` and setting
    ``P = Sigma^-1`` (reference ``src/priors/niw.jl:35``), but with no random
    matrix inverse: only a Cholesky of ``nu*Psi`` plus triangular solves.

    Args:
      key: PRNG key.
      nu:  [...] degrees of freedom (> D - 1 where mask).
      psi: [..., D, D] the NIW scale matrix in the reference's
           "divided-by-nu" parameterization.
      mask: [...] which batch entries are valid.
      chol_psi: optional precomputed lower Cholesky of ``psi`` (masked):
           ``chol(nu*psi) = sqrt(nu)*chol(psi)``, so a caller that already
           factored psi (e.g. for a log-determinant) skips the batched
           Cholesky here entirely.

    Returns:
      (prec, factors, logdet_sigma):
        prec    [..., D, D]  the sampled precision P
        factors dict with the triangular pieces 'l' (chol of nu*Psi, lower)
                and 'b' (Bartlett factor, lower): P = (L^-T B)(L^-T B)^T.
                Needed by :func:`sample_mvn_from_precision_factors`.
        logdet_sigma [...]   log|Sigma| = -log|P|
    """
    d = psi.shape[-1]
    batch_shape = psi.shape[:-2]
    nu = jnp.broadcast_to(jnp.asarray(nu, psi.dtype), batch_shape)

    # L L^T = nu * Psi  (scale matrix of the inverse-Wishart)
    if chol_psi is not None:
        l = jnp.sqrt(nu)[..., None, None] * chol_psi
    else:
        l = masked_cholesky(nu[..., None, None] * psi, mask)

    # Bartlett: B lower-triangular, B_ii^2 ~ chi^2_{nu - i}, B_ij ~ N(0,1).
    kg, kn = jax.random.split(key)
    i = jnp.arange(d, dtype=psi.dtype)
    df = jnp.maximum(nu[..., None] - i, 1e-3)  # [..., D]; guard masked slots
    # chi2_k = 2 * Gamma(k/2)
    chi2 = 2.0 * jax.random.gamma(kg, df / 2.0, dtype=psi.dtype)
    diag = jnp.sqrt(jnp.maximum(chi2, 1e-30))
    normals = jax.random.normal(kn, batch_shape + (d, d), dtype=psi.dtype)
    b = jnp.tril(normals, k=-1) + jnp.zeros_like(normals).at[
        ..., jnp.arange(d), jnp.arange(d)
    ].set(diag)

    # W ~ Wishart(nu, S) with S = (L L^T)^-1 has factor A = L^-T B:
    # A A^T = L^-T B B^T L^-1.  A is not triangular, but
    # det(A) = det(B) / det(L), so |P| = (prod diag B / prod diag L)^2.
    a = _batched_tri_solve(l, b, trans=True)  # solves L^T A = B
    prec = a @ jnp.swapaxes(a, -1, -2)
    prec = 0.5 * (prec + jnp.swapaxes(prec, -1, -2))
    logdet_prec = 2.0 * (
        jnp.sum(jnp.log(diag + 1e-30), axis=-1)
        - jnp.sum(
            jnp.log(jnp.abs(jnp.diagonal(l, axis1=-2, axis2=-1)) + 1e-30),
            axis=-1,
        )
    )
    return prec, {"l": l, "b": b}, -logdet_prec


def sample_mvn_from_precision_factors(
    key: jax.Array, mean: jax.Array, factors, kappa: jax.Array
):
    """Sample ``mu ~ N(mean, Sigma / kappa)`` for ``Sigma^-1 = A A^T``,
    ``A = L^-T B`` as produced by :func:`sample_wishart_precision`.

    A valid square root of Sigma is ``A^-T``, and since A itself is not
    triangular we use ``A^-T z = L (B^-T z)`` -- two triangular ops.
    mean: [..., D]; kappa: [...].
    """
    z = jax.random.normal(key, mean.shape, dtype=mean.dtype)
    y = _batched_tri_solve(factors["b"], z[..., None], trans=True)
    x = (factors["l"] @ y)[..., 0]
    return mean + x / jnp.sqrt(kappa)[..., None]


def sample_dirichlet(key: jax.Array, alpha: jax.Array) -> jax.Array:
    """Dirichlet sample along the last axis via normalized Gammas.

    Entries with ``alpha <= 0`` get weight exactly 0 (used for masked slots).
    """
    safe = jnp.maximum(alpha, 1e-6)
    g = jax.random.gamma(key, safe, dtype=jnp.float32)
    g = jnp.where(alpha > 0, g, 0.0)
    denom = jnp.sum(g, axis=-1, keepdims=True)
    return g / jnp.maximum(denom, 1e-30)
