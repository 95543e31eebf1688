"""10M-point sharded predict benchmark (VERDICT r4 #7).

Fits the 10M x 64-d config to ~converged K (fused blocks), then times
``DPMMModel.predict`` over all 10M rows -- the mesh-sharded chunked-scan
path (the reference's ``predict_points`` is master-only,
src/local_clusters_actions.jl:23-40).  Writes
benchmarks/results/predict_10M.json.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def main():
    import jax

    from dpmmsubclusters_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    import dpmmsubclusters_tpu as dpmm
    from dpmmsubclusters_tpu.api import _model_from_state
    from dpmmsubclusters_tpu.config import DPMMConfig
    from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh
    from dpmmsubclusters_tpu.priors import GAUSSIAN
    from dpmmsubclusters_tpu.sampler.driver import DPMMEngine

    n, d, k_true = 10_000_000, 64, 100
    rng = np.random.default_rng(0)
    means = rng.standard_normal((k_true, d)).astype(np.float32) * 8.0
    lab = rng.integers(0, k_true, size=n)
    x = means[lab] + rng.standard_normal((n, d)).astype(np.float32)

    cfg = DPMMConfig(k_max=256, chunk_size=16384, burnout=5, alpha=10.0,
                     verbose=False, track_posterior=False,
                     merge_candidates=1024)
    engine = DPMMEngine(GAUSSIAN, cfg, make_data_mesh())
    shift = x.mean(0)
    points, valid, n_total = engine.shard_points(x - shift)
    state = engine.init_state(
        jax.random.PRNGKey(1), points, valid, GAUSSIAN.default_prior(d))
    off = np.zeros(10, bool)
    grow = int(os.environ.get("GROW", "60"))
    for _ in range(max(1, grow // 10)):
        state, metrics = engine.step_block(
            state, points, valid, n_total, off, off)
    k_now = int(jax.device_get(metrics["k"])[-1])
    print(f"grown to K={k_now}", file=sys.stderr, flush=True)

    model = _model_from_state(GAUSSIAN, cfg, state, shift, n)
    # release the fit's device buffers: predict device_puts its own padded
    # copy of the rows, and 2x 2.56 GB + a [10M, K] probs block would OOM
    # the single chip
    del state, points, valid, n_total, metrics

    # labels-only predict over ALL 10M rows (no [N, K] host transfer)
    t0 = time.perf_counter()
    lab_pred, _ = model.predict(x, return_probs=False)
    t_label = time.perf_counter() - t0
    nmi = float(dpmm.nmi(lab, lab_pred))
    # the [N, K] probability path at 1M rows (a [10M, K] probs block is
    # ~4 GB and pointless to materialize host-side)
    t0 = time.perf_counter()
    lab2, probs = model.predict(x[:1_000_000])
    t_probs = time.perf_counter() - t0
    assert np.array_equal(lab_pred[:1_000_000], lab2)

    out = {
        "workload": "predict_10M",
        "n": n, "d": d, "k_live": k_now,
        "predict_labels_s": round(t_label, 2),
        "predict_labels_pts_per_s": round(n / t_label, 0),
        "predict_with_probs_1M_s": round(t_probs, 2),
        "probs_shape_1M": list(probs.shape),
        "nmi_vs_truth": round(nmi, 4),
        "note": "mesh-sharded chunked-scan predict incl. h2d of the raw "
                "rows + compile; reference predict_points is master-only",
    }
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "predict_10M.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
