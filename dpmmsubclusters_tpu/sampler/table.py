"""The padded fixed-capacity cluster table.

Replacement for the reference's dynamic ``Vector{local_cluster}``
(``src/ds.jl:43-57``): ``k_max`` slots of struct-of-arrays state with static
shapes under jit.  Cluster birth (split) activates a free slot; death
(merge / empty) deactivates one; the reference's label-renumbering compaction
(``src/local_clusters_actions.jl:446-471``) becomes a no-op during sampling --
labels are slot ids, densified only at export.

Table layout (a plain dict pytree; leading dim K = k_max unless noted):
  active      bool[K]    slot holds a live cluster
  is_outlier  bool[K]    slot is the fixed outlier component (never splits)
  prior       pytree[K,...]      per-slot prior hyperparams
  stats       pytree[K,3,...]    sufficient statistics; side 0=whole 1=left 2=right
  post        pytree[K,3,...]    posterior hyperparams per side
  params      pytree[K,3,...]    sampled distributions (family-specific; 'phi'
                                 is the natural-parameter row for the ll GEMM)
  lr_weights  f32[K,2]   sub-cluster mixture weights
  log_weights f32[K]     sampled global mixture log-weights (-inf inactive)
  hist        f32[K,B]   logsublikelihood ring buffer (B = burnout)
  splittable  bool[K]
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -jnp.inf


def side_tile(prior_k):
    """Broadcast per-slot prior [K, ...] to per-side [K, 3, ...]."""
    return jax.tree.map(
        lambda a: jnp.broadcast_to(a[:, None], (a.shape[0], 3) + a.shape[1:]),
        prior_k,
    )


def compute_posteriors(family, table):
    """Recompute all posterior hyperparams from the current statistics.

    Replaces ``update_splittable_cluster_params!``
    (src/local_clusters_actions.jl:137-147) for every slot and side at once.
    """
    post = family.calc_posterior(side_tile(table["prior"]), table["stats"])
    return {**table, "post": post}


def init_table(family, prior, outlier_prior, cfg, d: int):
    """Build the initial table: ``init_clusters`` active slots (plus slot 0
    as the outlier component when ``outlier_mod > 0``), statistics empty.

    Mirrors ``init_first_clusters!`` (src/dp-parallel-sampling.jl:62-78)
    minus the statistics pass, which the caller runs right after.
    """
    k = cfg.k_max
    has_outlier = cfg.outlier_mod > 0
    n_real = cfg.init_clusters
    n_active = n_real + (1 if has_outlier else 0)
    if n_active > k:
        raise ValueError(f"init_clusters={n_real} exceeds k_max={k}")

    idx = jnp.arange(k)
    active = idx < n_active
    is_outlier = (idx == 0) & has_outlier

    prior_k = family.tile_prior(prior, (k,))
    if has_outlier:
        if outlier_prior is None:
            outlier_prior = prior
        out_k = family.tile_prior(outlier_prior, (k,))
        prior_k = jax.tree.map(
            lambda main, out: jnp.where(
                is_outlier.reshape((k,) + (1,) * (main.ndim - 1)), out, main
            ),
            prior_k,
            out_k,
        )
    # cache prior-only log-marginal terms (ld0/lgmv0 for NIW); the extra
    # leaves ride every prior-row scatter/remap automatically
    prior_k = family.augment_prior(prior_k)

    stats = family.empty_stats((k, 3), d)
    post = family.calc_posterior(side_tile(prior_k), stats)
    table = {
        "active": active,
        "is_outlier": is_outlier,
        "prior": prior_k,
        "stats": stats,
        "post": post,
        "params": None,  # filled by the first parameter-sampling step
        "lr_weights": jnp.full((k, 2), 0.5, jnp.float32),
        "log_weights": jnp.where(active, 0.0, NEG_INF).astype(jnp.float32),
        "hist": jnp.full((k, cfg.burnout), NEG_INF, jnp.float32),
        "splittable": jnp.zeros((k,), bool),
        # slots awaiting a smart (PCA + 2-means) sub-label init: set by
        # split_move for both halves of an accepted split, consumed and
        # cleared by the block-boundary smart refresh (the reference
        # smart-inits exactly the newborn clusters,
        # src/local_clusters_actions.jl:374-378 -- NOT every slot every
        # block, which would clamp healthy sub-chains to PCA bisections)
        "needs_smart": jnp.zeros((k,), bool),
    }
    return table


def active_count(table) -> jax.Array:
    return jnp.sum(table["active"].astype(jnp.int32))


def retier(family, table, k_new: int):
    """Compact active slots to the front and resize the table to ``k_new``.

    The adaptive-capacity counterpart of the reference's label-renumbering
    compaction (``src/local_clusters_actions.jl:446-471``): every per-sweep
    cost is O(table width), so the engine runs at the smallest capacity tier
    with split headroom and migrates up/down as K changes (see
    ``driver.run_loop``).  Returns ``(table, lut)`` where ``lut`` maps old
    slot ids to new ones (apply to labels with ``jnp.take``).

    Caller guarantees ``k_new >= #active``.  Slot order is preserved, so the
    outlier component keeps slot 0.
    """
    k_old = table["active"].shape[0]
    act = table["active"]
    order = jnp.argsort(~act, stable=True)
    lut = (
        jnp.zeros((k_old,), jnp.int32)
        .at[order]
        .set(jnp.arange(k_old, dtype=jnp.int32))
    )
    # donor row for padded prior/params rows: any active non-outlier slot
    # (all real slots carry the same base prior; split only copies it).
    # Falls back to slot 0 when only the outlier is active.
    real = act & ~table["is_outlier"]
    donor = jnp.where(jnp.any(real), jnp.argmax(real), jnp.argmax(act))

    def remap(a, fill):
        g = jnp.take(a, order, axis=0)
        if k_new <= k_old:
            return g[:k_new]
        pad_shape = (k_new - k_old,) + a.shape[1:]
        if fill == "donor":
            pad = jnp.broadcast_to(a[donor][None], pad_shape)
        else:
            pad = jnp.full(pad_shape, fill, a.dtype)
        return jnp.concatenate([g, pad], axis=0)

    new = {
        "active": remap(table["active"], False),
        "is_outlier": remap(table["is_outlier"], False),
        "prior": jax.tree.map(lambda a: remap(a, "donor"), table["prior"]),
        "stats": jax.tree.map(lambda a: remap(a, 0.0), table["stats"]),
        "params": jax.tree.map(lambda a: remap(a, "donor"), table["params"]),
        "lr_weights": remap(table["lr_weights"], 0.5),
        "log_weights": remap(table["log_weights"], NEG_INF),
        "hist": remap(table["hist"], NEG_INF),
        "splittable": remap(table["splittable"], False),
        "needs_smart": remap(table["needs_smart"], False),
    }
    return compute_posteriors(family, new), lut


def whole_stats(table):
    return jax.tree.map(lambda a: a[:, 0], table["stats"])


def log_posterior(family, table, alpha, n_total):
    """DP-CRP log posterior (reference ``calculate_posterior``,
    src/dp-parallel-sampling.jl:458-470)."""
    from jax.scipy.special import gammaln

    stats_w = whole_stats(table)
    post_w = jax.tree.map(lambda a: a[:, 0], table["post"])
    prior_k = table["prior"]
    mask = table["active"] & (stats_w["n"] > 0)
    lm = family.log_marginal(prior_k, post_w, stats_w, mask)
    per_cluster = jnp.where(
        mask, lm + jnp.log(alpha) + gammaln(jnp.maximum(stats_w["n"], 1e-30)), 0.0
    )
    return (
        gammaln(alpha) - gammaln(n_total + alpha) + jnp.sum(per_cluster)
    )
