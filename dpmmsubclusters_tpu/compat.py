"""Drop-in style compatibility layer for users of the reference ecosystem.

The reference is consumed either from Julia (``DPMMSubClusters.fit``) or via
the out-of-tree Python wrapper ``dpmmpython`` (``README.md:7``), both using
the D x N data layout and 1-based labels.  This module mirrors those calling
conventions on top of this engine so existing scripts can switch by
changing an import.

    from dpmmsubclusters_tpu import compat as DPMMPython
    labels, clusters, weights = DPMMPython.fit(data, 100.0, iterations=100)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import api
from .priors import GAUSSIAN, MULTINOMIAL


def generate_gaussian_data(n: int, d: int, k: int, var: float, seed=None):
    """Reference layout: returns (x [D, N], labels 1-based, means, covs)."""
    from .utils.generators import generate_gaussian_data as gen

    x, labels, means, covs = gen(n, d, k, var, seed=seed)
    return x.T, labels + 1, means.T, np.moveaxis(covs, 0, -1)


def generate_mnmm_data(n: int, d: int, k: int, trials: int, seed=None):
    from .utils.generators import generate_mnmm_data as gen

    x, labels, clusters = gen(n, d, k, trials, seed=seed)
    return x.T, labels + 1, clusters.T


def fit(
    data,
    alpha: float,
    prior=None,
    *,
    iterations: int = 100,
    init_clusters: int = 1,
    seed: Optional[int] = None,
    verbose: bool = True,
    burnout: int = 20,
    gt=None,
    outlier_weight: float = 0.0,
    outlier_params=None,
    smart_splits: bool = False,
    **extra,
):
    """Reference-style fit: D x N data, 1-based labels.

    Returns (labels [N] 1-based, cluster_params list, weights) -- the
    essentials of the reference's 9-tuple (src/dp-parallel-sampling.jl:218);
    the full result object is available as ``fit_full``.
    """
    result = fit_full(
        data, alpha, prior,
        iterations=iterations, init_clusters=init_clusters, seed=seed,
        verbose=verbose, burnout=burnout, gt=gt,
        outlier_weight=outlier_weight, outlier_params=outlier_params,
        smart_splits=smart_splits, **extra,
    )
    return result.labels + 1, result.model.cluster_params(), result.weights


def fit_full(
    data,
    alpha: float,
    prior=None,
    *,
    iterations: int = 100,
    init_clusters: int = 1,
    seed: Optional[int] = None,
    verbose: bool = True,
    burnout: int = 20,
    gt=None,
    outlier_weight: float = 0.0,
    outlier_params=None,
    smart_splits: bool = False,
    **extra,
) -> api.FitResult:
    return api.fit(
        np.asarray(data).T,
        alpha=alpha,
        prior=prior,
        gt=None if gt is None else np.asarray(gt),
        outlier_prior=outlier_params,
        iters=iterations,
        init_clusters=init_clusters,
        seed=seed,
        verbose=verbose,
        burnout=burnout,
        outlier_mod=outlier_weight,
        smart_splits=smart_splits,
        **extra,
    )


def predict(model: api.DPMMModel, data):
    """D x N in, 1-based labels out (reference predict,
    src/dp-parallel-sampling.jl:532)."""
    labels, probs = model.predict(np.asarray(data).T)
    return labels + 1, probs


def calculate_posterior(model_or_result) -> float:
    """Reference ``calculate_posterior`` (src/dp-parallel-sampling.jl:458):
    the DP-CRP + marginal-likelihood log posterior of a fitted model."""
    m = getattr(model_or_result, "model", model_or_result)
    return m.log_posterior()


def save_model(model_or_result, path: str) -> None:
    """Reference ``save_model`` (src/dp-parallel-sampling.jl:450): write a
    resumable checkpoint (points are NOT stored, exactly like the
    reference's pts_less_group)."""
    m = getattr(model_or_result, "model", model_or_result)
    m.save(path)


def run_model_from_checkpoint(path: str, data, *, iterations=None, **kw):
    """Reference ``run_model_from_checkpoint``
    (src/dp-parallel-sampling.jl:428): resume from a checkpoint.  ``data``
    is D x N (reference layout); returns the same triple as :func:`fit`."""
    result = api.run_from_checkpoint(
        path, np.asarray(data).T, iters=iterations, **kw
    )
    return result.labels + 1, result.model.cluster_params(), result.weights


def dp_parallel(model_params: str):
    """Reference advanced mode ``dp_parallel(model_params::String)``
    (src/dp-parallel-sampling.jl:317): run a fit from a params file
    (declarative JSON here instead of executable Julia globals; see
    dpmmsubclusters_tpu.run for the schema)."""
    from .run import fit_from_params

    result = fit_from_params(model_params)
    return result.labels + 1, result.model.cluster_params(), result.weights


def get_labels_histogram(labels):
    """Reference ``get_labels_histogram`` (src/utils.jl:39-48) on 1-based
    labels: sorted (label, count) pairs."""
    from .utils.metrics import get_labels_histogram as _hist

    return sorted(_hist(np.asarray(labels)).items())
