"""The flagship fit over several fit seeds, at XLA's default matmul
precision and with every product at ``highest``.

    python benchmarks/flagship_seeds.py --seeds 2 3 4 5 \
        --precision default highest

Question it answers: does the precision of the unpinned f32 products (the
table math of ``priors/``, ``ops/linalg.py``, ``sampler/moves.py``; TF32 on
Ampere and later GPUs at the default) change how often the chain reaches the
planted K?  Data and fit arguments are ``chip_smoke.py``'s phase 1 (1M x
32-d, 64 planted components, data seed 0, ``k_max=128``).  Prints one JSON
line per (precision, seed): final K, NMI against the planted labels, K at
the end of each fused block, wall seconds, and the card.
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--precision", nargs="+", default=["default", "highest"],
                    choices=["default", "highest"])
    args = ap.parse_args()

    import jax

    import chip_smoke as C
    import dpmmsubclusters_tpu as dpmm
    from dpmmsubclusters_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    card = C.smi_text() if jax.default_backend() == "gpu" else "none"
    n, d, k_true, k_max, iters = C.FLAGSHIP_SHAPE
    x, gt = C.planted_gaussian(n, d, k_true, seed=0)
    block = dpmm.DPMMConfig().fused_block
    for prec in args.precision:
        for seed in args.seeds:
            ctx = (jax.default_matmul_precision("highest")
                   if prec == "highest" else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx:
                res = dpmm.fit(x, alpha=10.0, k_max=k_max, burnout=5,
                               merge_candidates=k_max, iters=iters,
                               seed=seed, verbose=False, gt=gt)
            print(json.dumps({
                "precision": prec, "seed": seed, "k": int(res.k),
                "nmi": dpmm.nmi(gt, res.labels),
                "k_per_block": res.history.k[block - 1::block],
                "wall_s": time.perf_counter() - t0,
                "backend": jax.default_backend(), "card": card,
            }), flush=True)


if __name__ == "__main__":
    main()
