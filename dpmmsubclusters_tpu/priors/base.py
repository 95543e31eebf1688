"""The conjugate-prior "family" protocol.

This is the batched re-design of the reference's 7-function extension
contract (``docs/src/priors.md:24-78``; implemented for NIW in
``src/priors/niw.jl`` and for Dirichlet/Multinomial in
``src/priors/multinomial_prior.jl``).  Differences from the reference, driven
by XLA's static-shape, batched execution:

* Everything is **batched struct-of-arrays**: hyperparameters, sufficient
  statistics and sampled parameters are pytrees (dicts of arrays) with
  arbitrary leading batch dimensions -- in the sampler the batch is
  ``[K_max, 3]`` (cluster slot x {whole, left-sub, right-sub}).  There are no
  per-cluster Python objects and no per-cluster loops.

* Per-point log-likelihood is expressed as a **linear functional of a feature
  map**:  ``ll[n, slot] = features(x_n) . phi[slot]``.  Every family supplies
  ``features`` ([N, D] -> [N, F]) and ``sample_params`` produces ``phi``
  ([..., F]).  This turns the hot per-point x per-cluster likelihood loop of
  the reference (``src/distributions/mv_gaussian.jl:21-25``,
  ``src/utils.jl:75-84``) into a single ``[N, F] @ [F, 3*K]`` matmul.

* Sufficient statistics are likewise linear: ``stat_features`` maps points to
  ``[N, S]`` rows whose masked segment-sum over label/sub-label one-hots
  yields all per-(slot, side) statistics as one ``[2K, N] @ [N, S]`` matmul
  (replacing ``create_sufficient_statistics`` + the hierarchical dict
  reduction of ``src/local_clusters_actions.jl:149-254``).

Families are plain modules of jittable functions; ``GAUSSIAN`` and
``MULTINOMIAL`` singletons are exported from :mod:`..priors`.
"""
from __future__ import annotations

from typing import Any, Protocol

import jax

Pytree = Any


class Family(Protocol):
    """Protocol implemented by :mod:`.niw` and :mod:`.dirichlet`."""

    name: str

    # ---- shapes -----------------------------------------------------------
    def feature_dim(self, d: int) -> int: ...
    def stat_dim(self, d: int) -> int: ...

    # ---- per-point linear maps (the hot path) -----------------------------
    def features(self, x: jax.Array) -> jax.Array: ...
    def stat_features(self, x: jax.Array) -> jax.Array: ...

    # ---- sufficient statistics -------------------------------------------
    def empty_stats(self, batch_shape: tuple, d: int) -> Pytree: ...
    def stats_from_flat(self, flat: jax.Array, d: int) -> Pytree: ...
    def stats_to_flat(self, stats: Pytree) -> jax.Array: ...
    def aggregate_stats(self, a: Pytree, b: Pytree) -> Pytree: ...

    # ---- conjugate updates ------------------------------------------------
    def calc_posterior(self, prior: Pytree, stats: Pytree) -> Pytree: ...
    def log_marginal(
        self, prior: Pytree, posterior: Pytree, stats: Pytree,
        mask: jax.Array, cache: Pytree = None,
    ) -> jax.Array: ...

    # ---- shared-work caches ------------------------------------------------
    # augment_prior: attach per-slot caches of prior-only log-marginal terms
    # as extra pytree leaves (they ride every prior-row scatter/remap).
    # posterior_cache: factor per-(posterior, mask) work ONCE and share it
    # between log_marginal and sample_params (for NIW: the psi Cholesky, a
    # batched factorization per call).  May return None.
    def augment_prior(self, prior_k: Pytree) -> Pytree: ...
    def posterior_cache(self, posterior: Pytree, mask: jax.Array) -> Pytree: ...

    # ---- sampling ---------------------------------------------------------
    def sample_params(
        self, key: jax.Array, hyper: Pytree, mask: jax.Array,
        cache: Pytree = None,
    ) -> Pytree: ...

    # ---- prediction -------------------------------------------------------
    def posterior_predictive(self, x: jax.Array, hyper: Pytree) -> jax.Array: ...

    # ---- convenience ------------------------------------------------------
    def default_prior(self, d: int) -> Pytree: ...
    def tile_prior(self, prior: Pytree, batch_shape: tuple) -> Pytree: ...
