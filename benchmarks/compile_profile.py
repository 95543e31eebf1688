"""Attribute the cold-start compile time of the sweep programs.

Times trace/lower (client side) and compile (backend) separately for each
engine program at flagship shapes (1M x 32-d), with the persistent compile
cache DISABLED, so the numbers are true cold costs.

Usage:  python benchmarks/compile_profile.py [K ...]   (default: 128)
        env SMALL_N=1 for a 131072-row variant (compile time is shape-
        independent to first order; data size only affects HBM)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

# true cold costs: the persistent cache stays off for this process
jax.config.update("jax_enable_compilation_cache", False)

T0 = time.time()


def log(msg):
    print(f"[{time.time() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def timeit(name, fn):
    t0 = time.time()
    r = fn()
    log(f"{name}: {time.time() - t0:.1f}s")
    return r


def main():
    from dpmmsubclusters_tpu.config import DPMMConfig
    from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh
    from dpmmsubclusters_tpu.priors import GAUSSIAN
    from dpmmsubclusters_tpu.sampler.driver import DPMMEngine

    ks = [int(a) for a in sys.argv[1:]] or [128]
    n = 131072 if os.environ.get("SMALL_N") else 1_000_000
    d = 32
    log(f"devices={jax.devices()} n={n}")

    mesh = make_data_mesh()
    prior = GAUSSIAN.default_prior(d)
    x = np.zeros((n, d), np.float32)

    for k in ks:
        cfg = DPMMConfig(
            k_max=k, chunk_size=16384, burnout=5, alpha=10.0, verbose=False,
            track_posterior=False, merge_candidates=4 * k,
            precompute_features=True,
        )
        engine = DPMMEngine(GAUSSIAN, cfg, mesh)
        points, valid, n_total = engine.shard_points(x)
        points = timeit(f"k={k} featurize(compile+run)",
                        lambda: jax.block_until_ready(engine.featurize(points)))
        state = timeit(
            f"k={k} init_state(compile+run)",
            lambda: engine.init_state(jax.random.PRNGKey(0), points, valid,
                                      prior),
        )
        jax.block_until_ready(state.table["log_weights"])

        f = jnp.asarray(False)
        low1 = timeit(
            f"k={k} step.lower",
            lambda: engine._step.lower(
                state.table, state.labels, state.sublabels, state.key,
                points, valid, n_total, f, f,
            ),
        )
        log(f"k={k} step IR bytes: {len(low1.as_text())}")
        timeit(f"k={k} step.compile", low1.compile)

        off = jnp.asarray(np.zeros(10, bool))
        low2 = timeit(
            f"k={k} block10.lower",
            lambda: engine._step_block.lower(
                state.table, state.labels, state.sublabels, state.key,
                points, valid, n_total, off, off,
            ),
        )
        log(f"k={k} block10 IR bytes: {len(low2.as_text())}")
        timeit(f"k={k} block10.compile", low2.compile)


if __name__ == "__main__":
    main()
