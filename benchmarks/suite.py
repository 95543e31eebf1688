"""Multi-config benchmark suite (the 5 BASELINE.json workloads).

Usage:
    python benchmarks/suite.py                # all fast configs
    python benchmarks/suite.py 2d mnm seg     # subset
    python benchmarks/suite.py flagship huge  # the big ones

Prints one human-readable row per config plus a JSON line each (stderr
carries progress).  The driver-facing single-number benchmark stays in
bench.py (flagship sweep throughput).

Reference numbers to beat (BASELINE.md):
  2d:  10k x 2, 100 iters   -- 1.068 s total on the reference dev machine
  seg: ~446k x 5, 300 iters -- ~77 s total on 4 worker procs
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_config(name, fit_kwargs, data, gt=None, warm=True):
    import dpmmsubclusters_tpu as dpmm

    if warm:
        # first run pays the jit compile; report the warm second run
        # (the reference's numbers likewise exclude Julia's JIT warmup)
        dpmm.fit(data, verbose=False, **fit_kwargs)
    t0 = time.perf_counter()
    res = dpmm.fit(data, verbose=False, **fit_kwargs)
    total = time.perf_counter() - t0
    iters = fit_kwargs.get("iters", 100)
    out = {
        "config": name,
        "n": len(data),
        "d": int(data.shape[1]),
        "iters": iters,
        "total_s": round(total, 3),
        "ms_per_sweep": round(total / iters * 1e3, 2),
        "pts_per_s": round(len(data) * iters / total, 1),
        "k_found": int(res.k),
    }
    if gt is not None:
        out["nmi"] = round(dpmm.nmi(gt, res.labels), 4)
    print(json.dumps(out), flush=True)
    return out


def main(which):
    import dpmmsubclusters_tpu as dpmm

    import jax

    from dpmmsubclusters_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    print(f"devices: {jax.devices()}", file=sys.stderr, flush=True)

    if "2d" in which:
        # reference getting_started benchmark: 1.068 s total
        x, gt, _, _ = dpmm.generate_gaussian_data(10_000, 2, 6, 100.0, seed=0)
        run_config("2d_gaussian_10k", dict(alpha=10.0, iters=100, seed=1,
                                           burnout=10, k_max=32), x, gt)
        # burnout=10 = the reference showcase recipe (getting_started.md:31-37)

    if "mnm" in which:
        x, gt, _ = dpmm.generate_mnmm_data(50_000, 100, 10, 120, seed=0)
        run_config(
            "multinomial_50k_d100",
            dict(alpha=1.0, iters=100, seed=1, family="multinomial",
                 burnout=10, k_max=32),
            x, gt,
        )

    if "seg" in which:
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "examples"))
        from image_segmentation import synthetic_image

        feats, gt = synthetic_image(h=871, w=512)  # ~446k pixels
        run_config("image_seg_446k_d5",
                   dict(alpha=10.0, iters=300, seed=1, k_max=64), feats, gt)

    if "seg_real" in which:
        # the reference's ACTUAL image-seg workload: its Sintel frame, its
        # 5-D features and data-driven prior, alpha=50000, 300 iters
        # (examples/image_seg/dpgmm-superpixels.jl).  Writes the JSON row +
        # segmentation image to benchmarks/results/r3/.
        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sys.path.insert(0, os.path.join(repo_root, "examples"))
        from image_segmentation import run_real, REF_FRAME

        run_real(REF_FRAME, 300,
                 os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "results", "r3"))

    if "flagship" in which:
        rng = np.random.default_rng(0)
        means = rng.standard_normal((64, 32)).astype(np.float32) * 8.0
        lab = rng.integers(0, 64, size=1_000_000)
        x = means[lab] + rng.standard_normal((1_000_000, 32)).astype(np.float32)
        run_config(
            "gaussian_1M_d32",
            dict(alpha=10.0, iters=60, seed=1, k_max=128, burnout=5,
                 track_posterior=False, merge_candidates=512),
            x, lab,
        )

    if "huge" in which:
        rng = np.random.default_rng(0)
        means = rng.standard_normal((100, 64)).astype(np.float32) * 8.0
        lab = rng.integers(0, 100, size=10_000_000)
        x = means[lab] + rng.standard_normal((10_000_000, 64)).astype(np.float32)
        run_config(
            "gaussian_10M_d64",
            # fixed capacity: one compiled program per run (tier engines
            # would each pay a compile on cold caches)
            dict(alpha=10.0, iters=30, seed=1, k_max=192, burnout=5,
                 track_posterior=False, merge_candidates=768,
                 auto_tier=False),
            x, lab,
        )

    if "huge_conv" in which:
        # BASELINE config 5 to CONVERGENCE: 10M x 64-d, 100 true clusters,
        # enough sweeps for K to plateau near the truth.  Drives the engine
        # directly (bench.py-style): fused 10-sweep blocks to steady state,
        # then a fenced timed window, then 5 argmax (final) sweeps --
        # mirroring run_model's argmax_sample_stop schedule -- and the
        # final-label NMI.
        import jax
        from dpmmsubclusters_tpu.config import DPMMConfig
        from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh
        from dpmmsubclusters_tpu.priors import GAUSSIAN
        from dpmmsubclusters_tpu.sampler.driver import DPMMEngine

        rng = np.random.default_rng(0)
        means = rng.standard_normal((100, 64)).astype(np.float32) * 8.0
        lab = rng.integers(0, 100, size=10_000_000)
        x = means[lab] + rng.standard_normal(
            (10_000_000, 64)).astype(np.float32)
        grow = int(os.environ.get("HUGE_GROW", "120"))

        cfg = DPMMConfig(k_max=256, chunk_size=16384, burnout=5, alpha=10.0,
                         verbose=False, track_posterior=False,
                         merge_candidates=1024)
        engine = DPMMEngine(GAUSSIAN, cfg, make_data_mesh())
        points, valid, n_total = engine.shard_points(x - x.mean(0))
        state = engine.init_state(
            jax.random.PRNGKey(1), points, valid, GAUSSIAN.default_prior(64))
        t0 = time.perf_counter()
        off = np.zeros(10, bool)
        k_hist = []
        for _ in range(grow // 10):
            state, metrics = engine.step_block(
                state, points, valid, n_total, off, off)
            k_hist.append(int(jax.device_get(metrics["k"])[-1]))
        grow_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(3):
            state, metrics = engine.step_block(
                state, points, valid, n_total, off, off)
        k_now = int(jax.device_get(metrics["k"])[-1])  # fence
        steady = (time.perf_counter() - t0) / 30
        # final argmax sweeps (reference argmax_sample_stop)
        state, metrics = engine.step_block(
            state, points, valid, n_total, np.ones(5, bool),
            np.ones(5, bool))
        labels = np.asarray(jax.device_get(state.labels)).reshape(-1)[
            : len(lab)]
        print(json.dumps({
            "config": "gaussian_10M_d64_converged",
            "n": 10_000_000, "d": 64, "k_true": 100,
            "sweeps_total": grow + 35,
            "grow_s_incl_compile": round(grow_s, 1),
            "k_history_per_block10": k_hist,
            "steady_ms_per_sweep": round(steady * 1e3, 1),
            "steady_pts_per_s": round(10_000_000 / steady, 0),
            "k_final": int(jax.device_get(metrics["k"])[-1]),
            "k_at_steady": k_now,
            "nmi_final": round(dpmm.nmi(lab, labels), 4),
        }), flush=True)

    if "huge_ckpt" in which:
        # BASELINE config 5's checkpoint/resume half at full 10M x 64 scale:
        # save mid-run, resume from the file, finish (reference
        # run_model_from_checkpoint, src/dp-parallel-sampling.jl:428-447)
        import tempfile

        rng = np.random.default_rng(0)
        means = rng.standard_normal((100, 64)).astype(np.float32) * 8.0
        lab = rng.integers(0, 100, size=10_000_000)
        x = means[lab] + rng.standard_normal((10_000_000, 64)).astype(np.float32)
        kw = dict(alpha=10.0, seed=1, k_max=192, burnout=5,
                  track_posterior=False, merge_candidates=768,
                  auto_tier=False, verbose=False)
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            res1 = dpmm.fit(x, iters=20, enable_saving=True,
                            model_save_interval=10, save_path=td + "/", **kw)
            t_fit = time.perf_counter() - t0
            ckpt = os.path.join(td, "checkpoint_10.npz")
            size_mb = os.path.getsize(ckpt) / 1e6
            # resume from sweep 10 and run TO CONVERGENCE: the artifact
            # shows the resumed chain reaches the same converged state
            # (K=100/NMI 1.0) an unbroken run does, not just that the
            # mechanics work (round-3 gap)
            t0 = time.perf_counter()
            res2 = dpmm.run_from_checkpoint(ckpt, x, iters=130, **kw)
            t_resume = time.perf_counter() - t0
        print(json.dumps({
            "config": "gaussian_10M_d64_ckpt_resume",
            "n": 10_000_000, "d": 64,
            "fit20_s": round(t_fit, 1),
            "resume_120more_s": round(t_resume, 1),
            "ckpt_mb": round(size_mb, 1),
            "k_at_save": int(res1.k), "k_after_resume": int(res2.k),
            "nmi_after_resume": round(dpmm.nmi(lab, res2.labels), 4),
        }), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:] or ["2d", "mnm", "seg"]
    main(args)
