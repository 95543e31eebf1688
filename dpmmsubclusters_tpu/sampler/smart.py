"""Smart split initialization: PCA projection + 1-D 2-means sub-labels.

Re-design of ``smart_cluster_init!`` and its worker kernels
(``src/local_clusters_actions.jl:555-653``).  The reference runs this
per-cluster with distributed RPC: master eigendecomposes the cluster
covariance, workers project their local points onto the top eigenvector, and
a master-coordinated 1-D 2-means labels each point left/right.  Here the
whole thing is one vectorized masked program over EVERY marked slot at once:

* covariance from the slot's whole-side sufficient statistics
  (``M = S/N - mu mu^T``, reference ``:557-560``);
* top eigenvector by batched power iteration (matmul-friendly; the
  reference's dense ``eigen`` needs only the principal vector -- note it
  actually takes a *row* of the eigenvector matrix, ``:566-568``, which is
  only correct by symmetry luck; we use the proper eigenvector);
* per-point projection ``t = v_label . (x - mu_label)`` -- ONE chunked pass
  materializing the [N] projection;
* 2-means init at the masked mean +/- std of ``t`` (the reference seeds from
  near-extreme percentiles, ``:645-650``; mean +/- std is the same idea
  without a distributed sort);
* ``max_split_iter`` Lloyd iterations whose per-slot sums are CHUNKED
  ONE-HOT MATMUL reductions (``oh^T @ vals``) rather than scatters; a
  ``psum`` over the data axis replaces the reference's master-side mean
  reduction (``:588-622``).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def top_eigvec(mat: jax.Array, iters: int = 25) -> jax.Array:
    """Principal eigenvector of a batch of symmetric PSD matrices [K, D, D]
    by power iteration (deterministic start along the largest diagonal)."""
    k, d, _ = mat.shape
    v0 = jnp.ones((k, d), mat.dtype) / jnp.sqrt(jnp.asarray(d, mat.dtype))

    def body(_, v):
        w = jnp.einsum("kde,ke->kd", mat, v,
                       precision=jax.lax.Precision.HIGHEST)
        nrm = jnp.linalg.norm(w, axis=-1, keepdims=True)
        return jnp.where(nrm > 1e-20, w / jnp.maximum(nrm, 1e-20), v)

    return jax.lax.fori_loop(0, iters, body, v0)


def _chunked(a, chunk):
    n = a.shape[0]
    assert n % chunk == 0, (n, chunk)
    return a.reshape((n // chunk, chunk) + a.shape[1:])


def smart_sublabels(
    points: jax.Array,      # [N, D] raw data rows
    valid: jax.Array,       # bool, lane-blocked [N/128, 128]
    labels: jax.Array,      # slot ids, lane-blocked [N/128, 128]
    sublabels: jax.Array,   # {0,1}, lane-blocked [N/128, 128]
    stats_w,                # whole-side stats pytree: n [K], sum_x [K,D], sum_xx [K,D,D]
    slots_mask: jax.Array,  # [K] bool: slots to (re)initialize
    max_iter: int,
    axis_name: Optional[str] = None,
    chunk: int = 16384,
) -> jax.Array:
    """Returns sub-labels (lane-blocked) with points of marked slots set by
    the projected 2-means; all other points keep their current sub-label."""
    blocked_shape = sublabels.shape
    n = points.shape[0]
    chunk = min(chunk, n)
    while n % chunk:
        chunk //= 2
    valid_f = valid.reshape(-1)
    labels_f = labels.reshape(-1)
    sublabels_f = sublabels.reshape(-1)
    k = slots_mask.shape[0]
    nk = jnp.maximum(stats_w["n"], 1.0)
    mu = stats_w["sum_x"] / nk[:, None]                     # [K, D]
    cov = stats_w["sum_xx"] / nk[:, None, None] - mu[:, :, None] * mu[:, None, :]
    v = top_eigvec(cov)                                     # [K, D]

    # projected-mean offset per slot: t = x . v_l - (mu . v)_l
    off = jnp.sum(mu * v, axis=-1)                          # [K]
    w_mask = slots_mask.astype(jnp.float32)                 # [K]

    def proj_body(carry, inp):
        xc, lc, vc = inp                                    # [C,D],[C],[C]
        oh = jax.nn.one_hot(lc, k, dtype=jnp.float32)       # [C, K]
        vl = jnp.dot(oh, v, precision=jax.lax.Precision.HIGHEST)  # [C, D]
        t = jnp.sum(xc * vl, axis=-1) - jnp.dot(oh, off)    # [C]
        w = jnp.dot(oh, w_mask) * vc                        # in-slot & valid
        # per-slot [cnt, sum t, sum t^2]
        acc = carry + jnp.dot(
            oh.T,
            jnp.stack([w, w * t, w * t * t], axis=-1),
            precision=jax.lax.Precision.HIGHEST,
        )
        return acc, (t, w)

    xs = (
        _chunked(points, chunk),
        _chunked(labels_f, chunk),
        _chunked(valid_f.astype(jnp.float32), chunk),
    )
    acc0 = jnp.zeros((k, 3), jnp.float32)
    acc, (t_all, w_all) = jax.lax.scan(proj_body, acc0, xs)
    if axis_name is not None:
        acc = jax.lax.psum(acc, axis_name)
    cnt = jnp.maximum(acc[:, 0], 1.0)
    mean = acc[:, 1] / cnt
    var = acc[:, 2] / cnt - mean**2
    std = jnp.sqrt(jnp.maximum(var, 1e-12))
    m = jnp.stack([mean - std, mean + std], axis=-1)        # [K, 2]

    # Lloyd iterations on the cached projections (t_all/w_all are the
    # scan-stacked [n_chunks, C] chunks)
    def lloyd(m):
        def body(acc, inp):
            tc, wc, lc = inp
            oh = jax.nn.one_hot(lc, k, dtype=jnp.float32)   # [C, K]
            m_pt = jnp.dot(oh, m)                           # [C, 2]
            side = (
                jnp.abs(tc - m_pt[:, 1]) < jnp.abs(tc - m_pt[:, 0])
            ).astype(jnp.float32)
            vals = jnp.stack(
                [wc * (1.0 - side), wc * side,
                 wc * (1.0 - side) * tc, wc * side * tc], axis=-1,
            )                                               # [C, 4]
            return acc + jnp.dot(
                oh.T, vals, precision=jax.lax.Precision.HIGHEST
            ), None

        acc, _ = jax.lax.scan(
            body, jnp.zeros((k, 4), jnp.float32), (t_all, w_all, xs[1])
        )
        if axis_name is not None:
            acc = jax.lax.psum(acc, axis_name)
        s0, s1, sum0, sum1 = acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3]
        return jnp.stack(
            [
                jnp.where(s0 > 0, sum0 / jnp.maximum(s0, 1.0), m[:, 0]),
                jnp.where(s1 > 0, sum1 / jnp.maximum(s1, 1.0), m[:, 1]),
            ],
            axis=-1,
        )

    # early-stopped: 1-D 2-means converges in a handful of iterations; the
    # movement tolerance is relative to the projection spread (std)
    tol = 1e-3 * jnp.maximum(jnp.max(std), 1e-12)

    def cond(carry):
        m, prev_move, it = carry
        return (it < max_iter) & (prev_move > tol)

    def step(carry):
        m, _, it = carry
        m2 = lloyd(m)
        return m2, jnp.max(jnp.abs(m2 - m)), it + 1

    m, _, _ = jax.lax.while_loop(
        cond, step, (m, jnp.float32(jnp.inf), jnp.int32(0))
    )

    # final assignment pass
    def assign_body(carry, inp):
        tc, wc, lc, sc = inp
        oh = jax.nn.one_hot(lc, k, dtype=jnp.float32)
        m_pt = jnp.dot(oh, m)
        side = (
            jnp.abs(tc - m_pt[:, 1]) < jnp.abs(tc - m_pt[:, 0])
        ).astype(sc.dtype)
        return carry, jnp.where(wc > 0, side, sc)

    _, sub_chunks = jax.lax.scan(
        assign_body, 0, (t_all, w_all, xs[1], _chunked(sublabels_f, chunk))
    )
    return sub_chunks.reshape(blocked_shape)
