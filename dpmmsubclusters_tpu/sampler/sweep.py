"""One full restricted-Gibbs sweep as a single SPMD program.

Replacement for ``group_step`` (src/local_clusters_actions.jl:658-673)
and its master/worker RPC choreography.  Order of sub-steps matches the
reference exactly:

  A. sample cluster params + weights                 (sample_clusters!)
  B. parameter broadcast -- implicit: the table is replicated; every device
     computes the same table update from the same PRNG key (no RPC, no retry
     machinery; reference :518-549)
  C. label sampling         \\
  D. sub-label sampling      }  fused one pass      (sample_labels! /
  E. sufficient statistics  /                        sample_sub_clusters! /
     + one psum over the data mesh axis              update_suff_stats_posterior!)
  F. reset bad clusters (sub-stats -> expectation under re-randomization)
  G. split moves (same expectation bookkeeping), merge moves
  H. deactivate empty slots

All table-level math is replicated across devices (identical keys -> identical
results); only points/labels/sub-labels are sharded; the only communication is
the O(K*S) statistics all-reduce -- the collective equivalent of the
reference's two-level node-leader reduction tree (src/utils.jl:51-64).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from . import assign as assign_mod
from . import moves
from . import smart as smart_mod
from .table import compute_posteriors, log_posterior, active_count

NEG_INF = -jnp.inf


def make_smart_pass(family, cfg, axis_name: Optional[str] = None):
    """Build the in-program smart sub-label pass: PCA + 2-means init + a
    statistics refresh for the slots marked ``needs_smart`` (set by
    split_move), clearing the marks.

    Runs INSIDE the compiled step/block programs (DPMMEngine) so there is
    no per-block host probe; the whole pass sits in one ``lax.cond`` on
    "any slot marked", so it costs nothing when nothing split.

    Matches the reference's per-newborn ``smart_cluster_init!``
    (src/local_clusters_actions.jl:374-378): ONLY newborn slots are
    (re)initialized -- refreshing every slot would clamp healthy
    sub-chains to PCA bisections and under-split overlapping mixtures.
    """
    chunk = cfg.chunk_size
    x_is_features = bool(cfg.precompute_features)

    def smart_pass(table, labels, sublabels, points, valid):
        prior = table["prior"]
        d = (prior["m"] if "m" in prior else prior["alpha"]).shape[-1]
        k_slots = table["active"].shape[0]
        mask = (
            table["needs_smart"] & table["active"] & ~table["is_outlier"]
        )
        any_mark = jnp.any(mask)
        raw = assign_mod.raw_points(points, d, x_is_features)

        def stats_refresh(table, sublabels):
            stats_lr = assign_mod.stats_only(
                points, valid, labels, sublabels, k_slots, family, chunk,
                x_is_features=x_is_features,
            )
            if axis_name is not None:
                stats_lr = jax.lax.psum(stats_lr, axis_name)
            flat3 = assign_mod.lr_to_full(stats_lr)
            stats = family.stats_from_flat(flat3, d)
            return compute_posteriors(family, {**table, "stats": stats})

        def do(args):
            table, sublabels = args
            stats_w = jax.tree.map(lambda a: a[:, 0], table["stats"])
            sub2 = smart_mod.smart_sublabels(
                raw, valid, labels, sublabels, stats_w, mask,
                cfg.max_split_iter, axis_name,
            )
            table = stats_refresh(table, sub2)
            return {**table, "needs_smart": table["needs_smart"] & ~mask}, \
                sub2

        return jax.lax.cond(
            any_mark, do, lambda args: args, (table, sublabels)
        )

    return smart_pass


def make_sweep(family, cfg, axis_name: Optional[str] = None):
    """Build the jittable sweep function.

    Returned signature:
      sweep(table, labels, sublabels, key, points, valid, n_total,
            final, no_more_splits) -> (table, labels, sublabels, key, metrics)

    ``final`` / ``no_more_splits`` are traced booleans so the same compiled
    program serves every iteration (including the fully-fused scan mode).
    """
    chunk = cfg.chunk_size
    alpha = float(cfg.alpha)
    outlier_mod = float(cfg.outlier_mod)
    # when True, `points` rows are precomputed feature rows, not raw data
    x_is_features = bool(cfg.precompute_features)

    def sweep(table, labels, sublabels, key, points, valid, n_total,
              final, no_more_splits):
        prior = table["prior"]
        d = (
            prior["m"] if "m" in prior else prior["alpha"]
        ).shape[-1]  # true data dim (points may hold feature rows)
        k_slots = table["active"].shape[0]

        def stats_pass(labels, sublabels):
            stats_lr = assign_mod.stats_only(
                points, valid, labels, sublabels, k_slots, family, chunk,
                x_is_features=x_is_features,
            )
            if axis_name is not None:
                stats_lr = jax.lax.psum(stats_lr, axis_name)
            return assign_mod.lr_to_full(stats_lr)

        def set_stats(table, flat3):
            stats = family.stats_from_flat(flat3, d)
            return compute_posteriors(family, {**table, "stats": stats})

        def gated_recompute(flag, table, labels, sublabels):
            """Refresh table statistics from (labels, sublabels) only when
            ``flag`` (used by the exact-post-move-stats path, whose
            redrawn sub-labels must be reflected in the stats)."""

            def recompute(args):
                table, labels, sublabels = args
                return set_stats(table, stats_pass(labels, sublabels))

            return jax.lax.cond(
                flag, recompute, lambda args: args[0],
                (table, labels, sublabels),
            )

        dev = (
            jax.lax.axis_index(axis_name)
            if axis_name is not None
            else jnp.int32(0)
        )
        key, ka, kb, kg1, kg2, krd = jax.random.split(key, 6)
        # Per-point randomness is keyed by GLOBAL chunk index (not device
        # index): every device gets the same base key `kb` and offsets by
        # its first chunk's global position, so a point's draws depend only
        # on its global row -- the trajectory is invariant to mesh size
        # (bit-exact whenever the f32 stats reduction is, e.g. the 4-corner
        # gate; see tests/test_fit_e2e.py::test_single_device_matches_multi).
        chunk_offset = dev * (assign_mod.points_rows(points) // chunk)

        # A + B: replicated parameter draws
        table = moves.sample_params_step(
            ka, table, alpha, outlier_mod, family,
            reference_gate=bool(cfg.reference_splittable_gate),
            freeze_outlier=(
                outlier_mod > 0 and not cfg.resample_outlier_params
            ),
        )

        # C + D + E: fused assignment & statistics
        hard = final | jnp.asarray(cfg.hard_clustering)
        labels, sublabels, stats_lr = assign_mod.assign_and_stats(
            kb,
            points,
            valid,
            table["params"]["phi"],
            table["log_weights"],
            jnp.log(jnp.maximum(table["lr_weights"], 1e-37)),
            hard,
            family,
            chunk,
            x_is_features=x_is_features,
            chunk_offset=chunk_offset,
        )
        if axis_name is not None:
            stats_lr = jax.lax.psum(stats_lr, axis_name)
        table = set_stats(table, assign_mod.lr_to_full(stats_lr))

        # F: reset clusters with an empty sub-cluster (sub-stats become the
        # halved whole-stats -- their expectation under re-randomized
        # sub-labels; no O(N) work at all, see moves.reset_bad)
        table, any_bad, bad_mask = moves.reset_bad(table, family)

        def redraw_and_recompute(krr, flag, slot_mask, table, labels,
                                 sublabels):
            """Reference-exact chain (cfg.exact_post_move_stats): points of
            the flagged slots get fresh Bernoulli(1/2) sub-labels and the
            table statistics are recomputed from realized labels with an
            O(N) pass (reset_bad_clusters! / split_cluster_local_worker!,
            src/local_clusters_actions.jl:265-278,481-516)."""
            in_slot = jnp.take(slot_mask, labels) & flag
            fresh = jax.random.bernoulli(
                jax.random.fold_in(krr, dev), 0.5, sublabels.shape
            ).astype(sublabels.dtype)
            sublabels = jnp.where(in_slot, fresh, sublabels)
            return gated_recompute(flag, table, labels, sublabels), sublabels

        if cfg.exact_post_move_stats:
            key, krb = jax.random.split(key)
            table, sublabels = redraw_and_recompute(
                krb, any_bad, bad_mask, table, labels, sublabels
            )

        # G: split + merge moves
        def do_moves(args):
            table, labels, sublabels = args
            # One shared [K, 3] log-marginal evaluation: split uses the
            # side rows, merge the whole row (slots whose stats change in
            # between -- split/reset-touched -- are merge-ineligible, so the
            # shared values stay valid).
            from .table import side_tile

            mask3 = jnp.broadcast_to(table["active"][:, None], (k_slots, 3))
            lm3 = family.log_marginal(
                side_tile(table["prior"]), table["post"], table["stats"],
                mask3, cache=family.posterior_cache(table["post"], mask3),
            )
            table, labels, sublabels, any_split, touched = moves.split_move(
                kg1, table, labels, sublabels, alpha, final, family,
                lm=lm3,
            )
            if cfg.exact_post_move_stats:
                # reference-exact: realized post-split sub-labels + stats
                # (krd is dedicated to this redraw -- kg1 was already
                # consumed by split_move's MH draws)
                table, sublabels = redraw_and_recompute(
                    krd, any_split, touched, table, labels, sublabels
                )
            # NOTE: smart splits (PCA + 2-means sub-label init,
            # resolved_smart_splits) run at BLOCK boundaries (the fused
            # block program / DPMMEngine.smart_refresh), NOT per sweep.
            # Newborn slots are burnout-gated for `burnout` sweeps, so a
            # once-per-block init loses nothing but a few sweeps of latency.
            table, labels, sublabels = moves.merge_move(
                kg2, table, labels, sublabels, alpha, final, family,
                lm_w=lm3[:, 0], candidates=cfg.merge_candidates,
            )
            return table, labels, sublabels

        def no_moves(args):
            return args

        table, labels, sublabels = jax.lax.cond(
            no_more_splits, no_moves, do_moves, (table, labels, sublabels)
        )

        # H: drop empty slots
        table = moves.remove_empty(table, outlier_mod)

        metrics = {
            "k": active_count(table),
            "log_posterior": (
                log_posterior(family, table, alpha, n_total)
                if cfg.track_posterior
                else jnp.float32(0.0)
            ),
        }
        return table, labels, sublabels, key, metrics

    return sweep
