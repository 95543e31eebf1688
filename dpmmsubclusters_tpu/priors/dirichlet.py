"""Dirichlet conjugate prior for multinomial-count clusters.

Re-design of ``src/priors/multinomial_prior.jl`` +
``src/distributions/multinomial_dist.jl``:

* posterior: ``alpha' = alpha + sum_x``        (multinomial_prior.jl:16-21)
* sampled cluster params: ``log p ~ log Dirichlet(alpha')``   (:23-25)
* per-point log-likelihood: ``ll = log_p . x`` -- exactly linear in the raw
  counts, so ``features(x) = x`` and the whole label-assignment matrix is a
  single [N, D] @ [D, 3K] matmul  (multinomial_dist.jl:13-15)
* log marginal likelihood via lgamma sums      (multinomial_prior.jl:34-39)
* posterior predictive: counts dotted with the log-normalized posterior mean
  (multinomial_prior.jl:45-48)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln


class MultinomialFamily:
    name = "multinomial"

    # ---- shapes -----------------------------------------------------------
    def feature_dim(self, d: int) -> int:
        return 1 + d

    def stat_dim(self, d: int) -> int:
        return 1 + d

    # ---- per-point linear maps -------------------------------------------
    def features(self, x: jax.Array) -> jax.Array:
        """[N, D] -> [N, 1 + D]: rows [1, x] -- shared by the ll matmul
        (phi = [0, log p]) and the statistics reduction."""
        n = x.shape[0]
        return jnp.concatenate([jnp.ones((n, 1), x.dtype), x], axis=1)

    def stat_features(self, x: jax.Array) -> jax.Array:
        """Alias: statistics rows ARE the feature rows (shared layout)."""
        return self.features(x)

    # ---- sufficient statistics -------------------------------------------
    def empty_stats(self, batch_shape: tuple, d: int):
        return {
            "n": jnp.zeros(batch_shape, jnp.float32),
            "sum_x": jnp.zeros(batch_shape + (d,), jnp.float32),
        }

    def stats_from_flat(self, flat: jax.Array, d: int):
        # ignore any zero lane-padding columns beyond 1 + d (padded
        # feature cache; see assign.LANE_PAD)
        return {"n": flat[..., 0], "sum_x": flat[..., 1 : 1 + d]}

    def stats_to_flat(self, stats) -> jax.Array:
        return jnp.concatenate([stats["n"][..., None], stats["sum_x"]], axis=-1)

    def aggregate_stats(self, a, b):
        return jax.tree.map(jnp.add, a, b)

    # ---- conjugate updates ------------------------------------------------
    def calc_posterior(self, prior, stats):
        has = (stats["n"] > 0)[..., None]
        return {"alpha": jnp.where(has, prior["alpha"] + stats["sum_x"], prior["alpha"])}

    def augment_prior(self, prior_k):
        """No expensive prior-only terms to cache (lgamma sums are cheap)."""
        return prior_k

    def posterior_cache(self, posterior, mask):
        """No factorization to share between log_marginal and sampling."""
        return None

    def log_marginal(self, prior, posterior, stats, mask,
                     cache=None) -> jax.Array:
        valid = mask & (stats["n"] > 0)
        a0, a1 = prior["alpha"], posterior["alpha"]
        out = (
            gammaln(jnp.sum(a0, axis=-1))
            - gammaln(jnp.sum(a1, axis=-1))
            + jnp.sum(gammaln(a1) - gammaln(a0), axis=-1)
        )
        return jnp.where(valid, out, 0.0)

    def log_marginal_pairwise(self, prior, stats, mask) -> jax.Array:
        """[K, K] log marginal likelihood of every merged pair (i, j) under
        prior_i (counterpart of the NIW version; lgamma sums only)."""
        sx = stats["sum_x"][:, None, :] + stats["sum_x"][None, :, :]
        n_m = stats["n"][:, None] + stats["n"][None, :]
        a0 = prior["alpha"][:, None, :]
        a1 = a0 + sx
        out = (
            gammaln(jnp.sum(a0, axis=-1))
            - gammaln(jnp.sum(a1, axis=-1))
            + jnp.sum(gammaln(a1) - gammaln(a0), axis=-1)
        )
        pair_mask = mask[:, None] & mask[None, :] & (n_m > 0)
        return jnp.where(pair_mask, out, 0.0)

    def merge_screen_score(self, post_w, params_w) -> jax.Array:
        """Cheap [K, K] mergeability score: negative Bhattacharyya affinity
        between posterior mean distributions (lower = closer)."""
        a = post_w["alpha"]
        p = a / jnp.sum(a, axis=-1, keepdims=True)
        sq = jnp.sqrt(jnp.maximum(p, 1e-30))
        aff = sq @ sq.T
        return -jnp.log(jnp.maximum(aff, 1e-30))

    # ---- sampling ---------------------------------------------------------
    def sample_params(self, key, hyper, mask, cache=None):
        """log p ~ log Dirichlet(alpha): normalized log-Gamma draws."""
        alpha = jnp.maximum(hyper["alpha"], 1e-6)
        g = jax.random.gamma(key, alpha, dtype=jnp.float32)
        g = jnp.maximum(g, 1e-37)
        log_g = jnp.log(g)
        log_p = log_g - jax.scipy.special.logsumexp(log_g, axis=-1, keepdims=True)
        zero = jnp.zeros(log_p.shape[:-1] + (1,), log_p.dtype)
        return {"phi": jnp.concatenate([zero, log_p], axis=-1), "log_p": log_p}

    # ---- prediction -------------------------------------------------------
    def posterior_predictive(self, x: jax.Array, hyper) -> jax.Array:
        """[N, D] x batched hyper [...] -> [N, ...]."""
        a = hyper["alpha"]
        v = jnp.log(a / jnp.sum(a, axis=-1, keepdims=True))  # [..., D]
        return jnp.einsum("nd,...d->n...", x, v)

    # ---- convenience ------------------------------------------------------
    def default_prior(self, d: int):
        return {"alpha": jnp.ones((d,), jnp.float32)}

    def make_prior(self, alpha):
        return {"alpha": jnp.asarray(alpha, jnp.float32)}

    def tile_prior(self, prior, batch_shape: tuple):
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, batch_shape + a.shape), prior
        )

    def shift_prior(self, prior, shift):
        # Counts data is never centered; shifting is a no-op.
        return prior


MULTINOMIAL = MultinomialFamily()
