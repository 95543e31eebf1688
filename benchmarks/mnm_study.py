"""Posterior-optimality study for the mnm parity config (VERDICT r4 #1).

Round 4 saw a K multimodality on the multinomial config (50k docs x
D=100, 10 planted components): most seeds land K in {9, 10}, 1-2/10
collapse to K=5, dragging pooled NMI down.  Question: are the low-K modes
posterior-preferred labelings of those datasets (components planted with
Dirichlet weights can be tiny/overlapping) or chain under-mixing?

Method mirrors benchmarks/gen2d_study.py: across data seeds x sampler
seeds, score the chain's final labeling AND the planted labeling with an
independent float64 evaluator of the DP posterior (CRP + Dirichlet
-multinomial marginals, reference calculate_posterior +
multinomial_prior.jl:34-39).  Writes benchmarks/results/mnm_study.json.
"""
import json
import math
import os
import sys

import numpy as np
from scipy.special import gammaln

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def labeling_log_posterior(x, labels, alpha):
    """f64 DP-CRP log posterior of a labeling for count data under the
    default Dirichlet(1) prior (multinomial coefficients omitted exactly
    as in the reference -- they are labeling-invariant)."""
    x = np.asarray(x, np.float64)
    d = x.shape[1]
    a0 = np.ones(d)
    lp = gammaln(alpha) - gammaln(len(x) + alpha)
    for k in np.unique(labels):
        c = x[labels == k].sum(0)
        a1 = a0 + c
        lp += (
            math.log(alpha) + gammaln((labels == k).sum())
            + gammaln(a0.sum()) - gammaln(a1.sum())
            + (gammaln(a1) - gammaln(a0)).sum()
        )
    return float(lp)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dpmmsubclusters_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    import dpmmsubclusters_tpu as dpmm

    data_seeds = int(os.environ.get("DATA_SEEDS", "6"))
    fit_seeds = int(os.environ.get("FIT_SEEDS", "4"))
    alpha = 1.0
    rows = []
    for ds in range(data_seeds):
        x, gt, _ = dpmm.generate_mnmm_data(50_000, 100, 10, 120, seed=ds)
        lp_planted = labeling_log_posterior(x, gt, alpha)
        for fs in range(fit_seeds):
            res = dpmm.fit(x, alpha=alpha, iters=100, burnout=10, seed=fs,
                           family="multinomial", verbose=False, k_max=32)
            lp_chain = labeling_log_posterior(x, res.labels, alpha)
            rows.append({
                "data_seed": ds, "fit_seed": fs,
                "k": int(res.k),
                "nmi": round(float(dpmm.nmi(gt, res.labels)), 4),
                "lp_chain": round(lp_chain, 1),
                "lp_planted": round(lp_planted, 1),
                "chain_minus_planted": round(lp_chain - lp_planted, 1),
            })
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)

    ks = np.array([r["k"] for r in rows])
    delta = np.array([r["chain_minus_planted"] for r in rows])
    out = {
        "recipe": "alpha=1, iters=100, burnout=10, Dirichlet(1) prior",
        "datasets": data_seeds, "fit_seeds": fit_seeds,
        "k_distribution": {str(k): int((ks == k).sum())
                           for k in sorted(set(ks.tolist()))},
        "chain_beats_planted_frac": round(float((delta >= 0).mean()), 3),
        "chain_minus_planted_mean": round(float(delta.mean()), 1),
        "chain_minus_planted_min": round(float(delta.min()), 1),
        "runs": rows,
    }
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "mnm_study.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "runs"},
                     indent=1))


if __name__ == "__main__":
    main()
