"""Params-file mode + CLI.

Counterpart of the reference's "advanced mode" -- ``dp_parallel(path)`` that
``include``s a Julia params file of globals and loads data from npy
(``src/dp-parallel-sampling.jl:317-334``, ``src/global_params.jl``).  Here
the params file is declarative JSON instead of executable code.

JSON keys = :class:`~dpmmsubclusters_tpu.config.DPMMConfig` fields, plus:

  data_path        path to the npy points file (required)
  data_transposed  true if the file is stored D x N (default false)
  family           "gaussian" (default) | "multinomial"
  alpha            DP concentration
  prior            family-specific prior arrays, e.g.
                   {"kappa": 1.0, "m": [0,0], "nu": 5.0, "psi": [[1,0],[0,1]]}
                   or {"alpha": [1, 1, ...]}
  outlier_prior    optional, same shape as prior
  gt_path          optional npy ground-truth labels (enables NMI reporting)

Run:      python -m dpmmsubclusters_tpu.run params.json
Resume:   python -m dpmmsubclusters_tpu.run --resume ckpt.npz params.json
          (optionally --iters N to extend the run; counterpart of the
          reference's ``run_model_from_checkpoint``,
          src/dp-parallel-sampling.jl:428-447)

Multi-process (one launch per process, e.g. one per GPU; counterpart of
the reference's multi-machine advanced mode,
src/dp-parallel-sampling.jl:317-334 + user-level ``addprocs``):

    python -m dpmmsubclusters_tpu.run --distributed params.json \
        --coordinator HOST:PORT --num-processes N --process-id I \
        --local-device-ids I

The three coordinator flags are given, not discovered.  ``data_path`` may
contain ``{proc}`` for per-process files; otherwise every process loads the
full file and takes its contiguous row slice.  ``--resume`` composes with
``--distributed``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .api import (FitResult, fit, fit_distributed, run_from_checkpoint,
                  run_from_checkpoint_distributed)
from .io.npy import load_data


def _validate_params(params: dict, path: str, *, need_gt: bool = True):
    """Fail fast on a malformed params file: require ``data_path`` and
    reject unknown keys with a named error, mirroring DPMMConfig's
    __post_init__ style (the reference silently accepts unused params-file
    globals, src/global_params.jl:39 -- a misspelled knob there is a no-op)."""
    import dataclasses

    from .config import DPMMConfig

    if "data_path" not in params:
        raise ValueError(
            f"params file {path!r}: missing required key 'data_path'"
        )
    allowed = {f.name for f in dataclasses.fields(DPMMConfig)} | {
        "data_path", "data_transposed", "family", "alpha", "prior",
        "outlier_prior", "gt_path",
    }
    unknown = sorted(set(params) - allowed)
    if unknown:
        raise ValueError(
            f"params file {path!r}: unknown key(s) {unknown} "
            f"(allowed: DPMMConfig fields plus data_path/data_transposed/"
            f"family/alpha/prior/outlier_prior/gt_path)"
        )
    if not need_gt and "gt_path" in params:
        params.pop("gt_path")


def fit_from_params(path: str) -> FitResult:
    """Load a JSON params file and run ``fit`` (reference
    ``dp_parallel(model_params::String)``, src/dp-parallel-sampling.jl:317)."""
    with open(path) as f:
        params = json.load(f)
    _validate_params(params, path)

    data = load_data(
        params.pop("data_path"),
        swapdims=bool(params.pop("data_transposed", False)),
    )
    gt = None
    if "gt_path" in params:
        gt = np.load(params.pop("gt_path")).astype(np.int64)

    prior = params.pop("prior", None)
    if prior is not None:
        prior = {k: np.asarray(v, np.float32) for k, v in prior.items()}
    outlier_prior = params.pop("outlier_prior", None)
    if outlier_prior is not None:
        outlier_prior = {
            k: np.asarray(v, np.float32) for k, v in outlier_prior.items()
        }
    family = params.pop("family", None)
    alpha = params.pop("alpha", 10.0)

    return fit(
        data, alpha=alpha, prior=prior, family=family, gt=gt,
        outlier_prior=outlier_prior, **params,
    )


def resume_from_params(ckpt: str, path: str, iters=None) -> FitResult:
    """Resume from a checkpoint; the params file supplies the data
    (``data_path``/``data_transposed``/``gt_path`` -- everything else comes
    from the checkpointed config, overridable via --iters)."""
    with open(path) as f:
        params = json.load(f)
    _validate_params(params, path)
    data = load_data(
        params.pop("data_path"),
        swapdims=bool(params.pop("data_transposed", False)),
    )
    gt = None
    if "gt_path" in params:
        gt = np.load(params.pop("gt_path")).astype(np.int64)
    return run_from_checkpoint(ckpt, data, iters=iters, gt=gt)


def _load_local_rows(params: dict) -> np.ndarray:
    """This process's data rows for distributed mode: a per-process file
    when ``data_path`` contains ``{proc}``, else a contiguous slice of the
    shared file by process index."""
    import jax

    path = params.pop("data_path")
    swap = bool(params.pop("data_transposed", False))
    if "{proc}" in path:
        return load_data(path.format(proc=jax.process_index()), swapdims=swap)
    x = load_data(path, swapdims=swap)
    n, p, i = len(x), jax.process_count(), jax.process_index()
    lo = (n * i) // p
    hi = (n * (i + 1)) // p
    return x[lo:hi]


def fit_from_params_distributed(path: str) -> FitResult:
    """Multi-host params-file mode: call after ``initialize()``; drives
    ``fit_distributed`` from the same JSON schema as single-host mode."""
    with open(path) as f:
        params = json.load(f)
    _validate_params(params, path, need_gt=False)  # labels are per-process;
    x_local = _load_local_rows(params)             # NMI is offline
    prior = params.pop("prior", None)
    if prior is not None:
        prior = {k: np.asarray(v, np.float32) for k, v in prior.items()}
    outlier_prior = params.pop("outlier_prior", None)
    if outlier_prior is not None:
        outlier_prior = {
            k: np.asarray(v, np.float32) for k, v in outlier_prior.items()
        }
    family = params.pop("family", None)
    alpha = params.pop("alpha", 10.0)
    return fit_distributed(
        x_local, alpha=alpha, prior=prior, family=family,
        outlier_prior=outlier_prior, **params,
    )


def resume_from_params_distributed(ckpt: str, path: str,
                                   iters=None) -> FitResult:
    with open(path) as f:
        params = json.load(f)
    _validate_params(params, path, need_gt=False)
    x_local = _load_local_rows(params)
    return run_from_checkpoint_distributed(ckpt, x_local, iters=iters)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dpmmsubclusters_tpu.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("params", help="JSON params file")
    ap.add_argument("--resume", metavar="CKPT",
                    help="checkpoint .npz to resume from")
    ap.add_argument("--iters", type=int, default=None,
                    help="with --resume: total iterations to run to")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process mode: initialize jax.distributed "
                         "and run fit_distributed (launch once per process)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-device-ids", default=None,
                    help="comma-separated local devices this process drives "
                         "(default: all)")
    args = ap.parse_args(argv)
    if args.distributed:
        from .parallel.distributed import initialize

        initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_device_ids=(
                None if args.local_device_ids is None
                else [int(i) for i in args.local_device_ids.split(",")]
            ),
        )
        if args.resume:
            result = resume_from_params_distributed(
                args.resume, args.params, args.iters
            )
        else:
            result = fit_from_params_distributed(args.params)
    elif args.resume:
        result = resume_from_params(args.resume, args.params, args.iters)
    else:
        result = fit_from_params(args.params)
    print(f"K = {result.k}")
    print(f"weights = {np.round(result.weights, 4).tolist()}")
    print(f"log_posterior = {result.model.log_posterior():.2f}")


if __name__ == "__main__":
    main()
