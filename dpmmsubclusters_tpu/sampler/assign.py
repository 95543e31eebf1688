"""The fused assignment + sufficient-statistics pass (the hot path).

Replaces the reference's three hot loops (SURVEY.md §3.2): per-point x
per-cluster log-likelihood (``src/distributions/mv_gaussian.jl:21-25``),
row-wise categorical sampling (``src/utils.jl:19-31``), and per-cluster
suff-stat GEMMs (``src/priors/niw.jl:42-51`` driven by
``create_suff_stats_dict_worker``).

Design: one ``lax.scan`` over point chunks; each chunk does
  1. ``feat = features(x)``                      [C, F]
  2. ``ll = feat @ phi^T``                       [C, 3K]  -- one matmul
     covering every slot's whole/left/right distribution at once
  3. label draw on the masked whole-columns (+ log weights)
  4. sub-label draw from the point's own slot's l/r columns (+ lr weights),
     selected by one-hot contraction -- no gathers
  5. ``stats += onehot(label, sub)^T @ stat_features(x)``  [2K, S] matmul

so the N x K likelihood matrix never materializes beyond one chunk, and the
only cross-device traffic per sweep is the final O(K*S) stats psum.  Both
matmuls run at ``Precision.HIGHEST`` (full f32).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp

NEG_INF = -jnp.inf
LANES = 128  # lane-blocked stream layout: per-point scalars are [N/128, 128]


def block_stream(a):
    """[N] per-point scalars -> canonical lane-blocked [N/128, 128].

    All label/sub-label/valid state is kept in this blocked layout
    end-to-end (the sharded state and checkpoints use it); host/flat
    views are reshapes.
    """
    n = a.shape[0]
    assert n % LANES == 0, (n, LANES)
    return a.reshape(n // LANES, LANES)


def unblock_stream(a):
    """Lane-blocked [rows, 128] -> flat [N]."""
    return a.reshape(-1)


def points_rows(points) -> int:
    """Global padded row count of a points container (array or the hybrid
    {"feat", "raw"} dict)."""
    return (points["raw"] if isinstance(points, dict) else points).shape[0]


def raw_points(points, d: int, x_is_features: bool):
    """Recover the raw [N, D] f32 points from any points container: the
    hybrid dict stores them directly; a feature cache holds them in columns
    1..D (rows are [1, x, ...])."""
    if isinstance(points, dict):
        return points["raw"]
    if x_is_features:
        return points[:, 1:1 + d].astype(jnp.float32)
    return points


def pad_features(feat):
    """Zero-pad the feature dim to a multiple of 128.

    LANE_PAD contract: precomputed feature caches are stored 128-aligned.
    phi rows are zero-padded to match (zero features x any phi contribute
    0 to the log-likelihood) and the trailing stats columns come back as
    zeros, sliced off in family.stats_from_flat."""
    f = feat.shape[-1]
    fp = -(-f // LANES) * LANES
    if fp == f:
        return feat
    pad = [(0, 0)] * (feat.ndim - 1) + [(0, fp - f)]
    return jnp.pad(feat, pad)


def _pad_phi_rows(phi_mat, f_pad: int):
    """[F, 3K] natural params -> [f_pad, 3K] with zero rows for the
    lane-padding feature columns."""
    f = phi_mat.shape[0]
    if f == f_pad:
        return phi_mat
    return jnp.pad(phi_mat, ((0, f_pad - f), (0, 0)))


def _chunk(x, chunk):
    n = x.shape[0]
    assert n % chunk == 0, (n, chunk)
    return x.reshape((n // chunk, chunk) + x.shape[1:])


def assign_and_stats(
    key,
    x,            # [N, D] local points (N % chunk == 0)
    valid,        # bool lane-blocked [N/128, 128]; padding rows contribute 0
    phi,          # [K, 3, F] natural params (whole, left, right)
    log_w,        # [K] mixture log-weights (-inf for inactive slots)
    log_lrw,      # [K, 2] sub-cluster mixture log-weights
    hard,         # bool scalar: argmax labels instead of sampling
    family,
    chunk: int,
    x_is_features: bool = False,
    chunk_offset=0,
):
    """Returns (labels i32[N/128, 128], sublabels i32[N/128, 128],
    stats_lr f32[K, 2, S]) -- per-point streams lane-blocked, see
    :func:`block_stream`.

    ``x_is_features``: the rows of ``x`` are already the feature rows
    (precomputed once per fit -- skips the per-sweep feature build).

    ``chunk_offset`` (traced i32): global index of this shard's first chunk.
    Per-point randomness is keyed on (key, global chunk index), so draws
    depend only on a point's global row position -- never on the mesh
    layout.
    """
    # feature_dtype="hybrid": x is {"feat": bf16 [N, Fpad] cache (ll matmul
    # only), "raw": f32 [N, D] points (exact statistics rows)}
    hybrid = isinstance(x, dict)
    x_ll = x["feat"] if hybrid else x
    k_slots = phi.shape[0]
    f = phi.shape[-1]
    d_raw = x["raw"].shape[-1] if hybrid else x.shape[-1]
    s = (
        family.stat_dim(d_raw)
        if (hybrid or not x_is_features) else x.shape[-1]
    )
    phi_mat = phi.reshape(3 * k_slots, f).T  # [F, 3K]
    if x_is_features:
        phi_mat = _pad_phi_rows(phi_mat, x_ll.shape[-1])  # lane-padded cache

    xs = (_chunk(x_ll, chunk), _chunk(unblock_stream(valid), chunk))
    if hybrid:
        xs = xs + (_chunk(x["raw"], chunk),)
    n_chunks = xs[0].shape[0]

    def body(carry, inp):
        acc, i = carry
        xc, vc = inp[:2]
        kc = jax.random.fold_in(key, jnp.int32(chunk_offset) + i)
        k1, k2 = jax.random.split(kc)

        # [C, F] -- shared by the ll matmul AND the stats reduction.  A
        # bf16 feature cache (config feature_dtype) is upcast here: bf16 is
        # STORAGE rounding only, all arithmetic is f32.
        feat = xc if x_is_features else family.features(xc)
        feat = feat.astype(jnp.float32)
        ll3 = jnp.dot(
            feat, phi_mat, precision=jax.lax.Precision.HIGHEST
        ).reshape(xc.shape[0], k_slots, 3)
        ll3 = jnp.nan_to_num(ll3, nan=NEG_INF, posinf=NEG_INF, neginf=NEG_INF)

        logits = ll3[:, :, 0] + log_w[None, :]  # [C, K]; -inf masks inactive
        labels = jnp.where(
            hard,
            jnp.argmax(logits, axis=-1),
            jax.random.categorical(k1, logits, axis=-1),
        ).astype(jnp.int32)

        oh = jax.nn.one_hot(labels, k_slots, dtype=jnp.float32)  # [C, K]
        ll_l = jnp.sum(oh * ll3[:, :, 1], axis=-1)
        ll_r = jnp.sum(oh * ll3[:, :, 2], axis=-1)
        lw = oh @ log_lrw  # [C, 2]
        logits2 = jnp.stack([ll_l + lw[:, 0], ll_r + lw[:, 1]], axis=-1)
        sub = jax.random.categorical(k2, logits2, axis=-1).astype(jnp.int32)

        ohs = (
            oh[:, :, None]
            * jax.nn.one_hot(sub, 2, dtype=jnp.float32)[:, None, :]
        ).reshape(xc.shape[0], 2 * k_slots)
        ohs = ohs * vc[:, None].astype(jnp.float32)
        if hybrid:
            # exact statistics rows rebuilt from the raw points; the bf16
            # cache never feeds the statistics contraction
            feat = family.stat_features(inp[2]).astype(jnp.float32)
        # full-f32 products: reduced-precision (bf16/TF32) operands suffer
        # catastrophic cancellation in cov = E[xx] - mu mu^T downstream
        acc = acc + jnp.dot(
            ohs.T, feat, precision=jax.lax.Precision.HIGHEST
        ).reshape(k_slots, 2, s)
        return (acc, i + 1), (labels, sub)

    acc0 = jnp.zeros((k_slots, 2, s), jnp.float32)
    (stats_lr, _), (labels, sublabels) = jax.lax.scan(
        body, (acc0, jnp.int32(0)), xs, length=n_chunks
    )
    return (
        block_stream(labels.reshape(-1)),
        block_stream(sublabels.reshape(-1)),
        stats_lr,
    )


def stats_only(
    x, valid, labels, sublabels, k_slots: int, family, chunk: int,
    x_is_features: bool = False,
):
    """Recompute per-(slot, side) statistics from given labels/sub-labels
    (all three streams lane-blocked [N/128, 128], see :func:`block_stream`).

    Used after split moves and bad-cluster resets rewrite labels
    (reference ``update_suff_stats_posterior!``,
    src/local_clusters_actions.jl:206-254).  Returns f32[K, 2, S].
    """
    if isinstance(x, dict):
        # feature_dtype="hybrid": statistics always come from the exact raw
        # points -- the bf16 cache is never involved in this pass
        x, x_is_features = x["raw"], False
    s = x.shape[-1] if x_is_features else family.stat_dim(x.shape[-1])
    xs = (
        _chunk(x, chunk),
        _chunk(unblock_stream(valid), chunk),
        _chunk(unblock_stream(labels), chunk),
        _chunk(unblock_stream(sublabels), chunk),
    )

    def body(acc, inp):
        xc, vc, lc, sc = inp
        oh = jax.nn.one_hot(lc, k_slots, dtype=jnp.float32)
        ohs = (
            oh[:, :, None]
            * jax.nn.one_hot(sc, 2, dtype=jnp.float32)[:, None, :]
        ).reshape(xc.shape[0], 2 * k_slots)
        ohs = ohs * vc[:, None].astype(jnp.float32)
        sfeat = xc if x_is_features else family.stat_features(xc)
        sfeat = sfeat.astype(jnp.float32)
        return acc + jnp.dot(
            ohs.T, sfeat, precision=jax.lax.Precision.HIGHEST
        ).reshape(k_slots, 2, s), None

    acc0 = jnp.zeros((k_slots, 2, s), jnp.float32)
    stats_lr, _ = jax.lax.scan(body, acc0, xs)
    return stats_lr


def lr_to_full(stats_lr):
    """[K, 2, S] left/right partial stats -> [K, 3, S] with whole = l + r."""
    whole = stats_lr[:, 0] + stats_lr[:, 1]
    return jnp.concatenate([whole[:, None], stats_lr], axis=1)
