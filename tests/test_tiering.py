"""Adaptive table-capacity tiers (sampler.table.retier + driver tier loop).

The reference never needs this -- its cluster vector grows dynamically
(``src/local_clusters_actions.jl:257-315``); under XLA static shapes the
equivalent is migrating between fixed-capacity compiled tiers, which must
preserve the sampler state exactly (up to slot renumbering).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dpmmsubclusters_tpu as dpmm
from dpmmsubclusters_tpu.config import DPMMConfig
from dpmmsubclusters_tpu.priors import GAUSSIAN
from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh
from dpmmsubclusters_tpu.sampler.driver import (
    DPMMEngine,
    TierMigrator,
    desired_tier,
    tier_sequence,
)


def test_tier_sequence():
    assert tier_sequence(128) == [16, 32, 64, 128]
    assert tier_sequence(100) == [16, 32, 64, 100]
    assert tier_sequence(16) == [16]
    assert tier_sequence(8) == [8]


def test_desired_tier_grow_shrink_hysteresis():
    tiers = tier_sequence(128)
    assert desired_tier(5, 16, tiers) == 32       # 4*5 > 16
    assert desired_tier(5, 32, tiers) == 32       # headroom ok
    assert desired_tier(40, 64, tiers) == 128     # 4*40 > 64
    assert desired_tier(40, 128, tiers) == 128    # capped at k_max
    assert desired_tier(2, 128, tiers) == 16      # 16*2 <= 128 -> >= 8*2
    # no flapping: the grow threshold after a shrink is not adjacent
    assert desired_tier(2, 16, tiers) == 16
    assert desired_tier(4, 16, tiers) == 16


@pytest.fixture(scope="module")
def settled():
    """A state with a few active clusters after some real sweeps."""
    rng = np.random.default_rng(0)
    means = rng.standard_normal((6, 4)).astype(np.float32) * 12
    lab = rng.integers(0, 6, 4000)
    x = means[lab] + rng.standard_normal((4000, 4)).astype(np.float32)

    mesh = make_data_mesh(8)
    cfg = DPMMConfig(k_max=16, chunk_size=512, burnout=5, alpha=10.0,
                     verbose=False)
    eng = DPMMEngine(GAUSSIAN, cfg, mesh)
    pts, valid, n_total = eng.shard_points(x - x.mean(0))
    st = eng.init_state(jax.random.PRNGKey(0), pts, valid,
                        GAUSSIAN.default_prior(4))
    off = np.zeros(30, bool)
    st, m = eng.step_block(st, pts, valid, n_total, off, off)
    return mesh, cfg, eng, st, pts, valid, n_total


def _copy_state(st):
    # TierMigrator donates the labels buffer; tests sharing the fixture
    # state must hand it a private copy
    from dpmmsubclusters_tpu.sampler.driver import DPMMState

    return DPMMState(
        table=st.table,
        labels=jnp.copy(st.labels),
        sublabels=st.sublabels,
        key=st.key,
        step=st.step,
    )


def test_retier_preserves_state(settled):
    mesh, cfg, eng, st, pts, valid, n_total = settled
    tab0 = jax.device_get(st.table)
    act0 = np.flatnonzero(tab0["active"])
    assert len(act0) >= 2

    st32 = TierMigrator(GAUSSIAN, mesh)(_copy_state(st), 32)
    tab1 = jax.device_get(st32.table)
    lab1 = np.asarray(jax.device_get(st32.labels))
    act1 = np.flatnonzero(tab1["active"])

    # active slots compact to a prefix, count preserved
    assert np.array_equal(act1, np.arange(len(act0)))
    # per-cluster counts preserved (sorted -- slot ids are renumbered)
    n0 = np.sort(np.asarray(tab0["stats"]["n"])[act0, 0])
    n1 = np.sort(np.asarray(tab1["stats"]["n"])[act1, 0])
    assert np.allclose(n0, n1)
    # labels remapped consistently with the migrated statistics
    vmask = np.asarray(jax.device_get(valid))
    hist = np.bincount(lab1[vmask], minlength=32)
    assert np.allclose(hist[act1], np.asarray(tab1["stats"]["n"])[act1, 0])
    # per-slot payloads preserved
    w0 = np.sort(np.asarray(tab0["log_weights"])[act0])
    w1 = np.sort(np.asarray(tab1["log_weights"])[act1])
    assert np.allclose(w0, w1)
    assert (
        np.asarray(tab0["splittable"]).sum()
        == np.asarray(tab1["splittable"]).sum()
    )


@pytest.mark.slow
def test_retier_roundtrip_continues_sampling(settled):
    mesh, cfg, eng, st, pts, valid, n_total = settled
    mig = TierMigrator(GAUSSIAN, mesh)
    st32 = mig(_copy_state(st), 32)
    eng32 = DPMMEngine(GAUSSIAN, cfg.replace(k_max=32), mesh)
    off = np.zeros(10, bool)
    st32, m = eng32.step_block(st32, pts, valid, n_total, off, off)
    assert int(jax.device_get(m["k"])[-1]) >= 2
    # shrink back and keep sampling
    st16 = mig(st32, 16)
    st16, m2 = eng.step_block(st16, pts, valid, n_total, off, off)
    assert int(jax.device_get(m2["k"])[-1]) >= 2
    assert np.isfinite(
        np.asarray(jax.device_get(st16.table["stats"]["n"]))
    ).all()


def test_fit_with_auto_tier_golden():
    """The 4-corner golden gate must hold with tier migrations enabled
    (reference test/module_tests.jl:10-32)."""
    x = np.zeros((1000, 2), np.float32)
    corners = np.array(
        [[10.0, 10.0], [-10.0, 10.0], [10.0, -10.0], [-10.0, -10.0]]
    )
    gt = np.zeros(1000, np.int64)
    for i in range(4):
        x[i * 250 : (i + 1) * 250] = corners[i]
        gt[i * 250 : (i + 1) * 250] = i
    res = dpmm.fit(x, alpha=100.0, iters=200, seed=12345, verbose=False,
                   k_max=64, auto_tier=True)
    assert res.k == 4
    hist = dpmm.get_labels_histogram(res.labels)
    assert sorted(hist.values()) == [250, 250, 250, 250]
    pred, _ = res.predict(x)
    assert np.array_equal(pred, res.labels)


def test_checkpoint_roundtrip_across_tiers(tmp_path):
    """A checkpoint saved at one capacity tier resumes at another."""
    rng = np.random.default_rng(1)
    means = rng.standard_normal((4, 3)).astype(np.float32) * 10
    lab = rng.integers(0, 4, 2000)
    x = means[lab] + rng.standard_normal((2000, 3)).astype(np.float32)

    res = dpmm.fit(x, alpha=10.0, iters=30, seed=4, k_max=16,
                   auto_tier=True, verbose=False, burnout=5)
    p = str(tmp_path / "tier_ck.npz")
    res.model.save(p)
    # resume with a larger fixed capacity: table must be migrated on load
    res2 = dpmm.run_from_checkpoint(p, x, iters=40, k_max=32,
                                    auto_tier=False, verbose=False)
    assert res2.k >= 1
    assert np.asarray(res2.model.table["active"]).shape[0] == 32


def test_max_clusters_caps_tier_ceiling():
    """With max_clusters set, the tier ceiling shrinks to the smallest
    tier covering the cap: capacity above it is pure table-width waste
    (splits are suppressed at the cap anyway, and every per-sweep cost
    grows with the table width)."""
    import dpmmsubclusters_tpu as dpmm

    rng = np.random.default_rng(2)
    x, gt, _, _ = dpmm.generate_gaussian_data(4_000, 2, 8, 80.0, seed=1)
    res = dpmm.fit(x, alpha=10.0, iters=40, seed=1, verbose=False,
                   burnout=3, k_max=64, max_clusters=14, auto_tier=True)
    # the table never grew past the 16-slot tier (smallest >= 14)
    assert np.asarray(res.model.table["active"]).shape[0] <= 16
    assert res.k <= 14
