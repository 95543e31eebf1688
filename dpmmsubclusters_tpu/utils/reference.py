"""Float64 NumPy reference for the assignment + statistics pass.

An independent, straightforward evaluation of what
``sampler.assign.assign_and_stats`` (hard mode) and
``sampler.assign.stats_only`` compute -- ``feat . phi`` logits, argmax
labels, one-hot sufficient statistics -- in float64 on the host, plus the
comparisons that hold the device results to it.  The CPU tests and the
on-card check (``chip_smoke.py`` phase 4, the ``gpu``-marked tests) share
these functions, so both apply the same tolerances:

* labels: at least ``LABEL_AGREEMENT`` of the rows agree, and every row
  that disagrees is a near tie (top-two f64 logits within ``TIE_RTOL``
  relative);
* statistics: ``|dev - ref| <= STATS_RTOL * |ref|
  + STATS_SUM_RTOL * sum|terms|``.
  The second term covers entries whose terms cancel (sum_x of centered
  data, off-diagonal sum_xx), where float32 accumulation in any order
  stays ~1e-7 of the summed magnitudes.  A product silently run with
  TF32 operands (10-bit mantissa, ~5e-4 relative per term) fails it.
"""
from __future__ import annotations

import numpy as np

LABEL_AGREEMENT = 0.9999
TIE_RTOL = 1e-4
STATS_RTOL = 1e-4
STATS_SUM_RTOL = 1e-6


def logits_f64(feat, phi_whole, log_w):
    """[N, F] feature rows x [K, F] whole-cluster natural params -> [N, K]
    float64 logits (inactive slots carry log_w = -inf)."""
    f = phi_whole.shape[-1]
    feat = np.asarray(feat, np.float64)[:, :f]
    return feat @ np.asarray(phi_whole, np.float64).T + np.asarray(
        log_w, np.float64)[None, :]


def stats_f64(stat_feat, labels, sublabels, valid, k_slots: int):
    """One-hot statistics in float64: returns (stats [K, 2, S], abs_sums
    [K, 2, S]) where abs_sums sums the magnitudes of the same terms."""
    sf = np.asarray(stat_feat, np.float64)
    lab = np.asarray(labels).reshape(-1)
    sub = np.asarray(sublabels).reshape(-1)
    w = np.asarray(valid).reshape(-1).astype(np.float64)
    oh = np.zeros((len(lab), 2 * k_slots))
    oh[np.arange(len(lab)), 2 * lab + sub] = w
    stats = (oh.T @ sf).reshape(k_slots, 2, -1)
    abs_sums = (oh.T @ np.abs(sf)).reshape(k_slots, 2, -1)
    return stats, abs_sums


def check_labels(labels_dev, logits, valid=None) -> dict:
    """Hold device argmax labels to the f64 logits: agreement share, and the
    largest relative top-two gap among disagreeing rows."""
    lab = np.asarray(labels_dev).reshape(-1)
    keep = (np.ones(len(lab), bool) if valid is None
            else np.asarray(valid).reshape(-1).astype(bool))
    lab, lg = lab[keep], logits[keep]
    ref = np.argmax(lg, axis=-1)
    bad = np.flatnonzero(lab != ref)
    top2 = np.sort(lg[bad], axis=-1)[:, -2:] if len(bad) else np.zeros((0, 2))
    gap = (np.abs(top2[:, 1] - top2[:, 0])
           / np.maximum(np.abs(top2[:, 1]), 1.0))
    worst = float(gap.max()) if len(bad) else 0.0
    agree = 1.0 - len(bad) / max(len(lab), 1)
    return {
        "label_agreement": agree,
        "label_disagreements": int(len(bad)),
        "worst_disagreement_gap": worst,
        "labels_ok": bool(agree >= LABEL_AGREEMENT and worst <= TIE_RTOL),
    }


def gaussian_features_f64(x):
    """[N, D] -> [N, 1 + D + D(D+1)/2] rows [1, x, triu(x x^T) row-major]."""
    x = np.asarray(x, np.float64)
    iu, ju = np.triu_indices(x.shape[1])
    return np.concatenate(
        [np.ones((len(x), 1)), x, x[:, iu] * x[:, ju]], axis=1)


def multinomial_features_f64(x):
    """[N, D] counts -> [N, 1 + D] rows [1, x]."""
    x = np.asarray(x, np.float64)
    return np.concatenate([np.ones((len(x), 1)), x], axis=1)


def gaussian_problem(n: int, d: int, k_slots: int, k_active: int,
                     seed: int = 0, n_valid=None):
    """A hard-mode assignment problem at real widths: ``k_active`` of
    ``k_slots`` slots hold sampled NIW parameters around well-separated
    means, the points are drawn around those means, and rows past
    ``n_valid`` are padding.  Returns a dict of host arrays."""
    import jax
    import jax.numpy as jnp

    from ..priors import GAUSSIAN

    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((k_slots, 3, d)) * 4.0).astype(np.float32)
    post = {
        "kappa": jnp.full((k_slots, 3), 5.0),
        "m": jnp.asarray(m),
        "nu": jnp.full((k_slots, 3), d + 5.0),
        "psi": jnp.broadcast_to(jnp.eye(d), (k_slots, 3, d, d)).astype(
            jnp.float32),
    }
    phi = np.asarray(GAUSSIAN.sample_params(
        jax.random.PRNGKey(seed), post, jnp.ones((k_slots, 3), bool))["phi"])
    truth = rng.integers(0, k_active, size=n)
    x = (m[truth, 0] + rng.standard_normal((n, d))).astype(np.float32)
    return _problem(x, phi, k_slots, k_active, rng, n_valid,
                    gaussian_features_f64)


def multinomial_problem(n: int, d: int, k_slots: int, k_active: int,
                        trials: int = 120, seed: int = 0, n_valid=None):
    """Multinomial counterpart of :func:`gaussian_problem`: the points are
    ``generate_mnmm_data`` count rows, phi = [0, log p] per slot."""
    from .generators import generate_mnmm_data

    rng = np.random.default_rng(seed)
    x, _, clusters = generate_mnmm_data(n, d, k_active, trials, seed=seed)
    p = np.full((k_slots, 3, d), 1.0 / d)
    p[:k_active] = rng.dirichlet(np.ones(d) * 50.0, size=(k_active, 3)) * 0.2
    p[:k_active] += 0.8 * clusters[:, None, :]
    phi = np.concatenate(
        [np.zeros((k_slots, 3, 1)), np.log(p)], axis=-1).astype(np.float32)
    return _problem(x, phi, k_slots, k_active, rng, n_valid,
                    multinomial_features_f64)


def _problem(x, phi, k_slots, k_active, rng, n_valid, features_f64):
    n = len(x)
    n_valid = n if n_valid is None else n_valid
    log_w = np.full(k_slots, -np.inf, np.float32)
    w = rng.dirichlet(np.ones(k_active) * 5.0)
    log_w[:k_active] = np.log(w)
    return {
        "x": x,
        "feat64": features_f64(x),
        "phi": phi,
        "log_w": log_w,
        "log_lrw": np.log(np.full((k_slots, 2), 0.5, np.float32)),
        "valid": np.arange(n) < n_valid,
        "labels": rng.integers(0, k_active, size=n).astype(np.int32),
        "sublabels": rng.integers(0, 2, size=n).astype(np.int32),
        "k_slots": k_slots,
    }


def check_problem(prob, family, chunk: int, precompute: bool = False,
                  feature_dtype=None, key_seed: int = 0) -> dict:
    """Run the plain path (``assign_and_stats`` in hard mode, then
    ``stats_only`` at the problem's random labels) on the default device
    and hold both to the float64 reference.  ``precompute`` streams a
    128-padded feature cache (config ``precompute_features``);
    ``feature_dtype`` "bfloat16"/"hybrid" store that cache in bf16 (then
    the reference uses the stored bf16 rows for the logits)."""
    import jax
    import jax.numpy as jnp

    from ..sampler import assign as A

    k = prob["k_slots"]
    x = jnp.asarray(prob["x"])
    valid = A.block_stream(jnp.asarray(prob["valid"]))
    feat64 = prob["feat64"]
    stat64 = feat64
    points = x
    if precompute:
        cache = A.pad_features(family.features(x))
        if feature_dtype in ("bfloat16", "hybrid"):
            cache = cache.astype(jnp.bfloat16)
            feat64 = np.asarray(cache.astype(jnp.float32), np.float64)
            if feature_dtype == "bfloat16":
                stat64 = feat64
        points = {"feat": cache, "raw": x} if feature_dtype == "hybrid" \
            else cache

    run = jax.jit(
        lambda key, pts, valid, phi, log_w, log_lrw: A.assign_and_stats(
            key, pts, valid, phi, log_w, log_lrw, jnp.asarray(True), family,
            chunk, x_is_features=precompute),
    )
    labels, sub, stats = run(
        jax.random.PRNGKey(key_seed), points, valid, jnp.asarray(prob["phi"]),
        jnp.asarray(prob["log_w"]), jnp.asarray(prob["log_lrw"]))
    out = check_labels(
        labels, logits_f64(feat64, prob["phi"][:, 0], prob["log_w"]),
        prob["valid"])
    out.update(check_stats(stats, *stats_f64(
        stat64, labels, sub, prob["valid"], k)))

    lab = A.block_stream(jnp.asarray(prob["labels"]))
    sl = A.block_stream(jnp.asarray(prob["sublabels"]))
    st_only = jax.jit(lambda pts, valid, lab, sl: A.stats_only(
        pts, valid, lab, sl, k, family, chunk, x_is_features=precompute))(
        points, valid, lab, sl)
    only = check_stats(st_only, *stats_f64(
        stat64, prob["labels"], prob["sublabels"], prob["valid"], k))
    out.update({f"stats_only_{name[6:]}": v for name, v in only.items()})
    out["ok"] = bool(out["labels_ok"] and out["stats_ok"]
                     and out["stats_only_ok"])
    return out


def check_stats(stats_dev, stats_ref, abs_sums) -> dict:
    """Hold device statistics [K, 2, S'] (S' may carry zero padding columns)
    to the f64 reference [K, 2, S]."""
    dev = np.asarray(stats_dev, np.float64)[..., : stats_ref.shape[-1]]
    err = np.abs(dev - stats_ref)
    bound = STATS_RTOL * np.abs(stats_ref) + STATS_SUM_RTOL * abs_sums
    scale = np.maximum(abs_sums, 1e-30)
    return {
        "stats_max_err_over_sum": float((err / scale).max()),
        "stats_violations": int((err > bound).sum()),
        "stats_ok": bool((err <= bound).all()),
    }
