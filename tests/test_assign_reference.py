"""The plain assignment + statistics pass against a float64 NumPy reference.

``sampler.assign`` is the sampler's one hot path.  These tests hold it to
``dpmmsubclusters_tpu.utils.reference`` (an independent f64 evaluation of
the same math) with the tolerances ``chip_smoke.py`` phase 4 applies on the
card, and check its sampling behaviour and layout invariances.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dpmmsubclusters_tpu.priors import GAUSSIAN, MULTINOMIAL
from dpmmsubclusters_tpu.sampler import assign as A
from dpmmsubclusters_tpu.utils import reference as R


def _flat_slots(n, d, k):
    """n points at the origin and k identical all-zero slots."""
    x = jnp.zeros((n, d), jnp.float32)
    phi = jnp.zeros((k, 3, GAUSSIAN.feature_dim(d)), jnp.float32)
    valid = A.block_stream(jnp.ones((n,), bool))
    return x, phi, valid


def test_sampling_is_calibrated():
    """Identical slots with given mixture weights -> empirical label
    frequencies match the weights, sub-labels split 50/50."""
    n, d, k = 4096, 4, 8
    x, phi, valid = _flat_slots(n, d, k)
    w = np.asarray([0.4, 0.3, 0.2, 0.05, 0.02, 0.01, 0.01, 0.01], np.float32)
    labels, sub, _ = A.assign_and_stats(
        jax.random.PRNGKey(7), x, valid, phi, jnp.log(jnp.asarray(w)),
        jnp.log(jnp.full((k, 2), 0.5)), jnp.asarray(False), GAUSSIAN, 512,
    )
    freq = np.bincount(np.asarray(labels).reshape(-1), minlength=k) / n
    np.testing.assert_allclose(freq, w, atol=0.03)
    side = np.bincount(np.asarray(sub).reshape(-1), minlength=2) / n
    np.testing.assert_allclose(side, [0.5, 0.5], atol=0.03)


def test_hard_mode_sublabels_stay_stochastic():
    """hard/final mode makes ONLY the label an argmax.  Sub-labels are
    always sampled -- the reference's sample_sub_clusters_worker! takes no
    `final` (src/local_clusters_actions.jl:64-95) -- so equal l/r
    sub-logits must give ~50/50 sides under hard=True."""
    n, d, k = 4096, 4, 8
    x, phi, valid = _flat_slots(n, d, k)
    _, sub, _ = A.assign_and_stats(
        jax.random.PRNGKey(11), x, valid, phi,
        jnp.log(jnp.full((k,), 1.0 / k)), jnp.log(jnp.full((k, 2), 0.5)),
        jnp.asarray(True), GAUSSIAN, 512,
    )
    side = np.bincount(np.asarray(sub).reshape(-1), minlength=2) / n
    np.testing.assert_allclose(side, [0.5, 0.5], atol=0.03)


@pytest.mark.parametrize("precompute", [False, True])
def test_gaussian_hard_labels_match_f64(precompute):
    prob = R.gaussian_problem(2048, 8, 32, 24, seed=1, n_valid=2000)
    out = R.check_problem(prob, GAUSSIAN, 512, precompute=precompute)
    assert out["labels_ok"] and out["label_disagreements"] == 0, out
    assert out["stats_ok"], out


def test_multinomial_hard_labels_match_f64():
    prob = R.multinomial_problem(2048, 100, 16, 10, seed=2, n_valid=2000)
    out = R.check_problem(prob, MULTINOMIAL, 512)
    assert out["labels_ok"], out
    assert out["stats_ok"], out


@pytest.mark.parametrize("mode", [
    "gaussian", "multinomial", "precomputed", "bfloat16", "hybrid",
])
def test_stats_only_matches_f64(mode):
    """stats_only at given labels, every storage layout of the points: raw
    Gaussian rows, count rows, the f32 feature cache, the bf16 cache
    (statistics of the stored bf16 rows) and the hybrid layout (statistics
    of the exact raw rows, never of the bf16 cache)."""
    if mode == "multinomial":
        prob, fam = R.multinomial_problem(2048, 100, 16, 10, seed=3), \
            MULTINOMIAL
    else:
        prob, fam = R.gaussian_problem(2048, 6, 16, 12, seed=3), GAUSSIAN
    out = R.check_problem(
        prob, fam, 512, precompute=mode in ("precomputed", "bfloat16",
                                            "hybrid"),
        feature_dtype={"bfloat16": "bfloat16", "hybrid": "hybrid"}.get(mode),
    )
    assert out["stats_only_ok"], out
    assert out["ok"], out


def test_padding_rows_contribute_nothing():
    """Rows with valid=False carry garbage; statistics equal those of the
    valid rows alone, and the labels of valid rows are unaffected."""
    prob = R.gaussian_problem(1024, 4, 16, 12, seed=4)
    x = np.asarray(prob["x"]).copy()
    valid = np.arange(1024) < 640
    x_garbage = x.copy()
    x_garbage[640:] = 1e4
    args = (jax.random.PRNGKey(0),)
    outs = []
    for pts in (x, x_garbage):
        outs.append(A.assign_and_stats(
            *args, jnp.asarray(pts), A.block_stream(jnp.asarray(valid)),
            jnp.asarray(prob["phi"]), jnp.asarray(prob["log_w"]),
            jnp.asarray(prob["log_lrw"]), jnp.asarray(True), GAUSSIAN, 256))
    (l1, s1, st1), (l2, s2, st2) = outs
    keep = valid.reshape(-1)
    np.testing.assert_array_equal(np.asarray(l1).reshape(-1)[keep],
                                  np.asarray(l2).reshape(-1)[keep])
    np.testing.assert_array_equal(np.asarray(s1).reshape(-1)[keep],
                                  np.asarray(s2).reshape(-1)[keep])
    np.testing.assert_allclose(np.asarray(st1), np.asarray(st2), rtol=1e-6,
                               atol=1e-6)
    ref, _ = R.stats_f64(R.gaussian_features_f64(x), l1, s1, valid, 16)
    np.testing.assert_allclose(np.asarray(st2), ref, rtol=1e-5, atol=1e-3)


def test_statistics_do_not_depend_on_chunk_size():
    """The scan chunk is a layout choice: hard labels are identical and the
    statistics agree to f32 summation order across chunk sizes."""
    prob = R.gaussian_problem(4096, 4, 16, 12, seed=5)
    x = jnp.asarray(prob["x"])
    valid = A.block_stream(jnp.asarray(prob["valid"]))
    lab = A.block_stream(jnp.asarray(prob["labels"]))
    sub = A.block_stream(jnp.asarray(prob["sublabels"]))
    st = [np.asarray(A.stats_only(x, valid, lab, sub, 16, GAUSSIAN, c))
          for c in (128, 1024, 4096)]
    for other in st[1:]:
        np.testing.assert_allclose(other, st[0], rtol=1e-5, atol=1e-3)
    labels = [np.asarray(A.assign_and_stats(
        jax.random.PRNGKey(0), x, valid, jnp.asarray(prob["phi"]),
        jnp.asarray(prob["log_w"]), jnp.asarray(prob["log_lrw"]),
        jnp.asarray(True), GAUSSIAN, c)[0]) for c in (128, 4096)]
    np.testing.assert_array_equal(labels[0], labels[1])


def _tf32(a):
    """Round float32 values to TF32's 10-bit mantissa (round to nearest)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def test_reference_check_rejects_tf32_operands():
    """Mutation check of the comparison itself: statistics accumulated from
    TF32-rounded feature rows (what a product silently lowered to TF32
    computes) fail ``check_stats``, exact f32 rows pass it."""
    prob = R.gaussian_problem(4096, 8, 16, 12, seed=6)
    feat = prob["feat64"]
    ref, abs_sums = R.stats_f64(feat, prob["labels"], prob["sublabels"],
                                prob["valid"], 16)
    f32_rows = feat.astype(np.float32).astype(np.float64)
    ok, _ = R.stats_f64(f32_rows, prob["labels"], prob["sublabels"],
                        prob["valid"], 16)
    assert R.check_stats(ok, ref, abs_sums)["stats_ok"]
    tf32_rows = _tf32(feat.astype(np.float32)).astype(np.float64)
    bad, _ = R.stats_f64(tf32_rows, prob["labels"], prob["sublabels"],
                         prob["valid"], 16)
    assert not R.check_stats(bad, ref, abs_sums)["stats_ok"]


def test_label_check_accepts_only_near_ties():
    logits = np.array([[0.0, -10.0], [-5.0, -5.0 + 1e-6], [1.0, -3.0]])
    tie = R.check_labels(np.array([0, 0, 0]), logits)
    assert tie["label_disagreements"] == 1
    assert tie["worst_disagreement_gap"] <= R.TIE_RTOL
    far = R.check_labels(np.array([1, 1, 0]), logits)
    assert not far["labels_ok"]
