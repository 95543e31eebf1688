"""Input-validation and checkpoint-versioning behavior.

The reference silently tolerates unused params-file keys
(``src/global_params.jl:39``) and lets a malformed prior fail deep inside
the sampler; here bad priors and bad config values fail fast with clear
errors, and checkpoints survive config-field evolution.
"""
import dataclasses
import json

import numpy as np
import pytest

import dpmmsubclusters_tpu as dpmm
from dpmmsubclusters_tpu.config import DPMMConfig


def _data(n=256, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)


# --- prior validation -------------------------------------------------------

def test_prior_typo_key_raises():
    with pytest.raises(ValueError, match="exactly the keys"):
        dpmm.fit(_data(), iters=2, verbose=False,
                 prior={"kappa": 1.0, "mu": np.zeros(3),  # typo: mu not m
                        "nu": 6.0, "psi": np.eye(3)})


def test_prior_wrong_dim_raises():
    with pytest.raises(ValueError, match="shape"):
        dpmm.fit(_data(d=3), iters=2, verbose=False,
                 prior={"kappa": 1.0, "m": np.zeros(4),  # D=4 vs data D=3
                        "nu": 6.0, "psi": np.eye(4)})


def test_prior_improper_nu_raises():
    with pytest.raises(ValueError, match="nu"):
        dpmm.fit(_data(d=3), iters=2, verbose=False,
                 prior={"kappa": 1.0, "m": np.zeros(3),
                        "nu": 1.0, "psi": np.eye(3)})


def test_outlier_prior_validated():
    with pytest.raises(ValueError, match="outlier_prior"):
        dpmm.fit(_data(d=3), iters=2, verbose=False,
                 outlier_mod=0.05,
                 outlier_prior={"kappa": 1.0})


def test_multinomial_prior_shape_raises():
    x = np.random.default_rng(0).integers(0, 5, size=(128, 4)).astype(
        np.float32)
    with pytest.raises(ValueError, match="shape"):
        dpmm.fit(x, iters=2, verbose=False, family="multinomial",
                 prior={"alpha": np.ones(3)})


# --- config validation -------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(alpha=0.0),
    dict(alpha=-1.0),
    dict(iters=0),
    dict(k_max=1),
    dict(burnout=0),
    dict(outlier_mod=1.0),
    dict(outlier_mod=-0.1),
    dict(feature_dtype="float16"),
    dict(max_clusters=0),
])
def test_config_rejects_bad_values(kw):
    with pytest.raises(ValueError, match="DPMMConfig"):
        DPMMConfig(**kw)


@pytest.mark.parametrize("knob,value", [
    ("use_pallas", True),
    ("ll_precision", "default"),
    ("stats_precision", "split2"),
])
def test_removed_kernel_knobs_raise_type_error(knob, value):
    """The fused-kernel knobs are gone: passing one is an unknown field,
    both to DPMMConfig and as a fit keyword."""
    with pytest.raises(TypeError, match=knob):
        DPMMConfig(**{knob: value})
    with pytest.raises(TypeError, match=knob):
        dpmm.fit(_data(), iters=2, verbose=False, **{knob: value})


def test_multinomial_smart_splits_raises():
    """Explicit smart_splits=True with multinomial fails fast (the init is
    covariance-PCA based); auto (None) resolves it off silently."""
    x = np.random.default_rng(0).integers(0, 5, size=(256, 6)).astype(
        np.float32)
    with pytest.raises(ValueError, match="smart_splits"):
        dpmm.fit(x, iters=2, verbose=False, family="multinomial",
                 smart_splits=True)
    assert DPMMConfig().resolved_smart_splits("multinomial") is False


def test_reference_verbatim_preset():
    cfg = DPMMConfig.reference_verbatim(seed=3, iters=7)
    assert cfg.reference_splittable_gate is True
    assert cfg.standardize_data is False
    assert cfg.exact_post_move_stats is True
    assert cfg.seed == 3 and cfg.iters == 7


# --- checkpoint versioning ---------------------------------------------------

def test_checkpoint_tolerates_unknown_config_keys(tmp_path):
    """A checkpoint written by a version with an extra config field must
    still load (with a warning), not die with a TypeError."""
    from dpmmsubclusters_tpu.io import checkpoint as ck

    x = _data(n=512, d=2, seed=1)
    res = dpmm.fit(x, iters=3, seed=0, verbose=False, k_max=8)
    p = str(tmp_path / "m.npz")
    res.model.save(p)

    # simulate a future config field inside the stored meta blob
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["meta"].tobytes()).decode())
    meta["config"]["some_future_knob"] = 42
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(p, **payload)

    with pytest.warns(UserWarning, match="some_future_knob"):
        out = ck.load_checkpoint(p)
    assert isinstance(out["config"], DPMMConfig)
    assert out["version"] == ck.FORMAT_VERSION

    # and the resumed run works end-to-end
    res2 = dpmm.run_from_checkpoint(p, x, iters=5)
    assert res2.model.step >= 3


def test_checkpoint_missing_key_defaults(tmp_path):
    """A checkpoint written BEFORE a config field existed (key absent) loads
    with the current default."""
    from dpmmsubclusters_tpu.io import checkpoint as ck

    x = _data(n=512, d=2, seed=1)
    res = dpmm.fit(x, iters=3, seed=0, verbose=False, k_max=8)
    p = str(tmp_path / "m.npz")
    res.model.save(p)
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["meta"].tobytes()).decode())
    del meta["config"]["track_posterior"]
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(p, **payload)
    out = ck.load_checkpoint(p)
    assert out["config"].track_posterior == DPMMConfig().track_posterior


# --- distributed standardization robustness (ADVICE r3 medium) ---------------

def test_fit_large_offset_standardization():
    """|mean| >> sd data: the two-pass variance keeps standardization
    effective (the raw-moment difference would cancel in f32 and clamp
    scale to 1)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4096, 2)) * np.array([1e-2, 1e-2])
         + np.array([4096.0, -8192.0])).astype(np.float32)
    res = dpmm.fit(x, iters=5, seed=0, verbose=False, k_max=8)
    scale = res.model._scale
    # effective scale ~ 1/sd = ~100, nowhere near the clamp value 1
    assert np.all(scale > 10.0), scale


def test_params_file_schema_validated(tmp_path):
    """Params files fail fast with named errors on unknown keys or a
    missing data_path (the reference silently ignores unused params-file
    globals, src/global_params.jl:39 -- a misspelled knob is a no-op)."""
    import json

    import numpy as np

    from dpmmsubclusters_tpu.run import fit_from_params

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"data_path": "x.npy", "alhpa": 10.0}))
    with pytest.raises(ValueError, match="unknown key.*alhpa"):
        fit_from_params(str(bad))

    nodata = tmp_path / "nodata.json"
    nodata.write_text(json.dumps({"alpha": 10.0}))
    with pytest.raises(ValueError, match="data_path"):
        fit_from_params(str(nodata))


def test_transposed_layout_and_unknown_fit_kwarg():
    """transposed=True accepts the reference's D x N layout; a misspelled
    fit kwarg fails fast as a TypeError from DPMMConfig, not deep in jit."""
    import dpmmsubclusters_tpu as dpmm

    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(-6, 1, (300, 2)), rng.normal(6, 1, (300, 2))
    ]).astype(np.float32)
    r = dpmm.fit(x.T, alpha=10.0, iters=30, seed=0, verbose=False,
                 k_max=8, burnout=3, transposed=True)
    assert len(r.labels) == 600
    assert r.k == 2

    with pytest.raises(TypeError):
        dpmm.fit(x, alpha=10.0, itres=30)  # typo'd kwarg


def test_resume_wrong_size_data_rejected(tmp_path):
    """Resuming with a dataset of the wrong size fails fast with a named
    error (the checkpoint's label stream refers to specific rows)."""
    import dpmmsubclusters_tpu as dpmm

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (500, 2)).astype(np.float32)
    r = dpmm.fit(x, alpha=10.0, iters=10, seed=0, verbose=False, k_max=4,
                 burnout=3)
    path = str(tmp_path / "ck.npz")
    r.model.save(path)
    with pytest.raises(ValueError, match="trained on 500 points"):
        dpmm.run_from_checkpoint(path, x[:400], iters=12, verbose=False)
