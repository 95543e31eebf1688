"""Benchmark: Gibbs-sweep throughput on the flagship 1M x 32-d Gaussian config.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "points/s", "vs_baseline": N}

Baseline: the reference publishes no 1M x 32-d number.  Extrapolating its
strongest in-repo evidence -- the image-segmentation run (446k pts, D=5,
K=26, 0.28-0.45 s/iter on 4 worker procs => ~1.1M pts/s; BASELINE.md) -- by
the sampler's O(K * D^2) per-point cost to K=128, D=32 gives
  1.1e6 * (26*25) / (128*1024) ~= 5.5e3 pts/s on 4 procs
  => ~4.4e4 pts/s on a 32-core host (8x procs; we credit linear scaling to
     be conservative -- the reference reports sublinear, docs/src/perf.md).
BASELINE_PTS_PER_S below is that 32-core estimate; vs_baseline > 10 meets
the north-star (>=10x a 32-core Julia host, BASELINE.md).
"""
import json
import os
import sys
import time

import numpy as np

BASELINE_PTS_PER_S = 4.4e4

SMALL = os.environ.get("BENCH_SMALL", "") not in ("", "0")
# cache-layout override for A/B runs: float32 | bfloat16 | hybrid
FDT = os.environ.get("BENCH_FDT", "") or None
T0 = time.time()


def log(msg):
    print(f"[bench {time.time() - T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def main():
    import jax

    from dpmmsubclusters_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()

    from dpmmsubclusters_tpu.config import DPMMConfig
    from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh
    from dpmmsubclusters_tpu.priors import GAUSSIAN
    from dpmmsubclusters_tpu.sampler.driver import DPMMEngine

    if SMALL:
        n, d, k_true, k_max, warmup, timed = 100_000, 32, 20, 32, 10, 10
    else:
        # block length 16 = the product default (DPMMConfig.fused_block).
        # warmup runs 5 blocks (compile + settle K to its converged value
        # -- the chain reaches K=64 around sweep 60); the timed window then
        # chains 5 block dispatches with ONE final sync over 80
        # steady-state sweeps
        n, d, k_true, k_max, warmup, timed = 1_000_000, 32, 64, 128, 80, 16

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    if dev.platform == "gpu":
        import subprocess

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        log(f"nvidia-smi: {smi.stdout.strip()}")

    # synthetic mixture (separated means, unit covs) -- gen speed irrelevant
    rng = np.random.default_rng(0)
    means = rng.standard_normal((k_true, d)).astype(np.float32) * 8.0
    labels = rng.integers(0, k_true, size=n)
    x = means[labels] + rng.standard_normal((n, d)).astype(np.float32)
    log("data generated")

    # merge_candidates = k_max: top-K screened pairs cover every
    # plausible merge at K<=64 live clusters (r4 A/B: 3 seeds K=64 /
    # NMI 1.0, same as 4*k_max, -0.5 ms/sweep of candidate Cholesky work)
    cfg = DPMMConfig(k_max=k_max, chunk_size=16384, burnout=5, alpha=10.0,
                     verbose=False, track_posterior=False,
                     merge_candidates=k_max, precompute_features=True,
                     **({"feature_dtype": FDT} if FDT else {}))
    mesh = make_data_mesh()
    engine = DPMMEngine(GAUSSIAN, cfg, mesh)
    points, valid, n_total = engine.shard_points(x - x.mean(0))
    points = engine.featurize(points)
    jax.block_until_ready(points)
    log("points sharded + featurized (h2d done)")
    prior = GAUSSIAN.default_prior(d)
    state = engine.init_state(jax.random.PRNGKey(0), points, valid, prior)
    jax.block_until_ready(state.table["log_weights"])
    log("init done")

    # warmup uses the SAME block length as the timed run -- a different
    # length would recompile the scan and pollute the timing.  The smart
    # sub-label pass for newborn slots runs INSIDE the block program (a
    # gated near-no-op when nothing split), so the dispatch loop is just
    # blocks.
    off = np.zeros(timed, bool)
    for _ in range(max(1, warmup // timed)):
        state, metrics = engine.step_block(
            state, points, valid, n_total, off, off
        )
    k_active = int(metrics["k"][-1])
    log(f"warmup blocks done (compile + settle): K={k_active}")

    # timed window = exactly what run_loop executes per block at steady
    # state, fenced once at the end
    blocks = 5
    t0 = time.perf_counter()
    for i in range(blocks):
        state, metrics = engine.step_block(
            state, points, valid, n_total, off, off
        )
    k_final = int(metrics["k"][-1])  # sync once, after all blocks
    dt = time.perf_counter() - t0

    pts_per_s = n * timed * blocks / dt
    log(f"timed: {dt / (timed * blocks) * 1e3:.1f} ms/sweep, K={k_final}")
    print(json.dumps({
        "metric": "gibbs_sweep_throughput_1Mx32d",
        "value": round(pts_per_s, 1),
        "unit": "points/s",
        "vs_baseline": round(pts_per_s / BASELINE_PTS_PER_S, 2),
    }))


if __name__ == "__main__":
    main()
