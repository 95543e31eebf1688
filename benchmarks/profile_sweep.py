"""Component-level timing of the flagship sweep on the current backend.

Each component is jitted alone and timed over ``reps`` back-to-back
dispatches with ONE fence (``jax.block_until_ready``) at the end; the
device kind and count are printed first.

Usage: python benchmarks/profile_sweep.py [n] [d] [k_max]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from dpmmsubclusters_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from dpmmsubclusters_tpu.config import DPMMConfig
    from dpmmsubclusters_tpu.parallel.mesh import DATA_AXIS, make_data_mesh
    from dpmmsubclusters_tpu.priors import GAUSSIAN
    from dpmmsubclusters_tpu.sampler import assign as assign_mod
    from dpmmsubclusters_tpu.sampler import moves as moves_mod
    from dpmmsubclusters_tpu.sampler.driver import DPMMEngine
    from dpmmsubclusters_tpu.sampler.sweep import make_sweep
    from dpmmsubclusters_tpu.sampler.table import compute_posteriors, side_tile

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    k_max = int(sys.argv[3]) if len(sys.argv) > 3 else 128

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f"  n={n} d={d} k_max={k_max}", file=sys.stderr, flush=True)

    cfg = DPMMConfig(k_max=k_max, chunk_size=16384, burnout=5, alpha=10.0,
                     verbose=False, track_posterior=False,
                     merge_candidates=4 * k_max,
                     precompute_features=True)  # match bench.py's flagship
    mesh = make_data_mesh()
    engine = DPMMEngine(GAUSSIAN, cfg, mesh)

    rng = np.random.default_rng(0)
    means = rng.standard_normal((64, d)).astype(np.float32) * 8.0
    lab = rng.integers(0, 64, size=n)
    x = means[lab] + rng.standard_normal((n, d)).astype(np.float32)
    points, valid, n_total = engine.shard_points(x - x.mean(0))
    points = engine.featurize(points)
    prior = GAUSSIAN.default_prior(d)
    state = engine.init_state(jax.random.PRNGKey(0), points, valid, prior)

    # settle toward converged K with real sweeps first (block length 16
    # matches bench.py so the compile cache is warm)
    off = np.zeros(16, bool)
    for _ in range(6):
        state, metrics = engine.step_block(state, points, valid, n_total,
                                           off, off)
    k_now = int(jax.device_get(metrics["k"])[-1])
    print(f"settled: K={k_now}", file=sys.stderr, flush=True)

    def timeit(fn, sync_leaf, reps=20):
        jax.block_until_ready(sync_leaf(fn(0)))
        t0 = time.perf_counter()
        for r in range(1, reps + 1):
            out = fn(r)
        jax.block_until_ready(sync_leaf(out))
        return (time.perf_counter() - t0) * 1e3 / reps

    dspec, rspec = P(DATA_AXIS), P()
    table = state.table

    def _assign(r, table, points, valid):
        return assign_mod.assign_and_stats(
            jax.random.fold_in(jax.random.PRNGKey(9), r), points, valid,
            table["params"]["phi"], table["log_weights"],
            jnp.log(jnp.maximum(table["lr_weights"], 1e-37)),
            jnp.asarray(False), GAUSSIAN, cfg.chunk_size,
            x_is_features=bool(cfg.precompute_features))

    # NOTE: points/valid are jit ARGUMENTS everywhere below -- closure
    # capture would inline them as constants (GBs per compile)
    assign_j = jax.jit(shard_map(
        _assign, mesh=mesh, in_specs=(rspec, rspec, dspec, dspec),
        out_specs=(dspec, dspec, rspec), check_vma=False))

    def _stats(r, labels, sublabels, points, valid):
        del r
        return assign_mod.stats_only(
            points, valid, labels, sublabels, k_max, GAUSSIAN,
            cfg.chunk_size, x_is_features=bool(cfg.precompute_features))

    stats_j = jax.jit(shard_map(
        _stats, mesh=mesh,
        in_specs=(rspec, dspec, dspec, dspec, dspec), out_specs=rspec,
        check_vma=False))

    def _sample(r, table):
        return moves_mod.sample_params_step(
            jax.random.fold_in(jax.random.PRNGKey(8), r), table, cfg.alpha,
            cfg.outlier_mod, GAUSSIAN)["params"]["phi"]

    sample_j = jax.jit(_sample)

    def _post(r, table):
        return compute_posteriors(GAUSSIAN, table)["post"]["m"] + r

    post_j = jax.jit(_post)

    def _lm3(r, table):
        k = table["active"].shape[0]
        return GAUSSIAN.log_marginal(
            side_tile(table["prior"]), table["post"], table["stats"],
            jnp.broadcast_to(table["active"][:, None], (k, 3))) + r

    lm3_j = jax.jit(_lm3)

    def _merge(r, table, labels, sublabels):  # no data deps
        k = table["active"].shape[0]
        lm3 = GAUSSIAN.log_marginal(
            side_tile(table["prior"]), table["post"], table["stats"],
            jnp.broadcast_to(table["active"][:, None], (k, 3)))
        t2, l2, s2 = moves_mod.merge_move(
            jax.random.fold_in(jax.random.PRNGKey(7), r), table, labels,
            sublabels, cfg.alpha, jnp.asarray(False), GAUSSIAN,
            lm_w=lm3[:, 0], candidates=cfg.merge_candidates)
        return t2["stats"]["n"]

    merge_j = jax.jit(shard_map(
        _merge, mesh=mesh, in_specs=(rspec, rspec, dspec, dspec),
        out_specs=(rspec), check_vma=False))

    sweep = make_sweep(GAUSSIAN, cfg, axis_name=DATA_AXIS)

    def _sweep(r, table, labels, sublabels, nms, points, valid,
               n_total):
        return sweep(table, labels, sublabels,
                     jax.random.fold_in(jax.random.PRNGKey(6), r),
                     points, valid, n_total, jnp.asarray(False), nms)

    sweep_j = jax.jit(shard_map(
        _sweep, mesh=mesh,
        in_specs=(rspec, rspec, dspec, dspec, rspec, dspec, dspec, rspec),
        out_specs=(rspec, dspec, dspec, rspec, rspec), check_vma=False))

    res = {}
    res["assign"] = timeit(
        lambda r: assign_j(r, table, points, valid), lambda o: o[2])
    res["stats"] = timeit(
        lambda r: stats_j(r, state.labels, state.sublabels, points, valid),
        lambda o: o)
    res["sample_params"] = timeit(lambda r: sample_j(r, table), lambda o: o)
    res["posteriors"] = timeit(lambda r: post_j(r, table), lambda o: o)
    res["log_marginal3"] = timeit(lambda r: lm3_j(r, table), lambda o: o)
    res["merge_move"] = timeit(
        lambda r: merge_j(r, table, state.labels, state.sublabels),
        lambda o: o)
    res["sweep_nosplit"] = timeit(
        lambda r: sweep_j(r, table, state.labels, state.sublabels,
                          jnp.asarray(True), points, valid, n_total),
        lambda o: o[4]["k"])
    res["sweep_full"] = timeit(
        lambda r: sweep_j(r, table, state.labels, state.sublabels,
                          jnp.asarray(False), points, valid, n_total),
        lambda o: o[4]["k"])

    for k, v in res.items():
        print(f"{k:<14} {v:8.2f} ms")


if __name__ == "__main__":
    main()
