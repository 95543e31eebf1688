"""Posterior-optimality study for the gen2d parity config (VERDICT r4 #1).

Question: parity runs land K=5 on gen2d dataset seed 0 while the
reference's showcase (docs/src/getting_started.md:35-37) reports K=6 /
NMI 1.0 on *a* dataset of the same generator.  Is K=5 an under-split
(chain bias) or the true posterior optimum of that dataset?

Method: for each data seed, run the showcase recipe (alpha=10, 100 iters,
burnout=10) over several sampler seeds, then score BOTH the chain's final
labeling and the PLANTED labeling with an independent float64
numpy/scipy evaluator of the DP-mixture log posterior (CRP term + NIW
log marginals under the raw-space default prior NIW(1, 0, D+3, I) --
the same quantity as reference calculate_posterior,
src/dp-parallel-sampling.jl:458-470).  The chain wins if its labeling's
posterior >= the planted one's; a chain stuck below the planted score
would indicate under-mixing.

Writes benchmarks/results/gen2d_study.json.
"""
import json
import math
import os
import sys

import numpy as np
from scipy.special import gammaln, multigammaln

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def niw_log_marginal_f64(pts, kappa0, m0, nu0, psi0):
    """f64 NIW log marginal likelihood of a point set (niw.jl:53-62)."""
    n, d = pts.shape
    sx = pts.sum(0)
    sxx = pts.T @ pts
    kappa1 = kappa0 + n
    nu1 = nu0 + n
    m1 = (kappa0 * m0 + sx) / kappa1
    psi1 = (nu0 * psi0 + kappa0 * np.outer(m0, m0)
            - kappa1 * np.outer(m1, m1) + sxx) / nu1
    psi1 = 0.5 * (psi1 + psi1.T)
    return (
        -n * d * 0.5 * math.log(math.pi)
        + multigammaln(nu1 / 2.0, d)
        - multigammaln(nu0 / 2.0, d)
        + (nu0 / 2.0) * (d * math.log(nu0) + np.linalg.slogdet(psi0)[1])
        - (nu1 / 2.0) * (d * math.log(nu1) + np.linalg.slogdet(psi1)[1])
        + (d / 2.0) * math.log(kappa0 / kappa1)
    )


def labeling_log_posterior(x, labels, alpha):
    """DP-CRP log posterior of a labeling, f64 (calculate_posterior)."""
    x = np.asarray(x, np.float64)
    d = x.shape[1]
    kappa0, m0, nu0, psi0 = 1.0, np.zeros(d), d + 3.0, np.eye(d)
    lp = gammaln(alpha) - gammaln(len(x) + alpha)
    for k in np.unique(labels):
        pts = x[labels == k]
        lp += (math.log(alpha) + gammaln(len(pts))
               + niw_log_marginal_f64(pts, kappa0, m0, nu0, psi0))
    return float(lp)


def main():
    import jax

    # CPU: tiny fits; keeps the accelerator free for big jobs
    jax.config.update("jax_platforms", "cpu")
    from dpmmsubclusters_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    import dpmmsubclusters_tpu as dpmm

    data_seeds = int(os.environ.get("DATA_SEEDS", "10"))
    fit_seeds = int(os.environ.get("FIT_SEEDS", "5"))
    alpha = 10.0
    rows = []
    for ds in range(data_seeds):
        x, gt, _, _ = dpmm.generate_gaussian_data(10_000, 2, 6, 100.0,
                                                  seed=ds)
        lp_planted = labeling_log_posterior(x, gt, alpha)
        # planted components can be tiny (Dirichlet(1) weights) or overlap
        counts = np.bincount(gt)
        for fs in range(fit_seeds):
            res = dpmm.fit(x, alpha=alpha, iters=100, burnout=10, seed=fs,
                           verbose=False, k_max=32)
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
        rows[-1]["planted_counts"] = sorted(counts.tolist())

    ks = np.array([r["k"] for r in rows])
    delta = np.array([r["chain_minus_planted"] for r in rows])
    out = {
        "recipe": "alpha=10, iters=100, burnout=10 (reference showcase)",
        "datasets": data_seeds, "fit_seeds": fit_seeds,
        "k_distribution": {str(k): int((ks == k).sum())
                           for k in sorted(set(ks.tolist()))},
        "chain_beats_planted_frac": round(float((delta >= 0).mean()), 3),
        "chain_minus_planted_mean": round(float(delta.mean()), 1),
        "chain_minus_planted_min": round(float(delta.min()), 1),
        "runs": rows,
    }
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "gen2d_study.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "runs"},
                     indent=1))


if __name__ == "__main__":
    main()
