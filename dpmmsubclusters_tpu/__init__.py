"""dpmmsubclusters_tpu: a DPMM sub-cluster sampler framework for GPUs.

A from-scratch JAX/XLA re-design of the capabilities of
BGU-CS-VIL/DPMMSubClusters.jl (Chang & Fisher NIPS-2013 parallel sub-cluster
sampler for Dirichlet-process mixture models): restricted Gibbs sweeps with
auxiliary 2-way sub-clusters and Metropolis-Hastings split/merge moves, for
conjugate exponential-family priors (Gaussian/NIW and Multinomial/Dirichlet),
data-sharded over device meshes (one or several GPUs).
"""

from .config import DPMMConfig
from .priors import GAUSSIAN, MULTINOMIAL
from .priors.niw import GaussianFamily
from .priors.dirichlet import MultinomialFamily
from .api import (
    DPMMModel,
    FitResult,
    fit,
    fit_distributed,
    run_from_checkpoint,
    run_from_checkpoint_distributed,
)
from .io.npy import load_data
from .io.checkpoint import load_checkpoint, save_checkpoint
from .utils.generators import generate_gaussian_data, generate_mnmm_data
from .utils.metrics import get_labels_histogram, nmi, varinfo

__version__ = "0.1.0"

__all__ = [
    "DPMMConfig",
    "DPMMModel",
    "FitResult",
    "GAUSSIAN",
    "MULTINOMIAL",
    "GaussianFamily",
    "MultinomialFamily",
    "fit",
    "fit_distributed",
    "run_from_checkpoint",
    "run_from_checkpoint_distributed",
    "load_data",
    "load_checkpoint",
    "save_checkpoint",
    "generate_gaussian_data",
    "generate_mnmm_data",
    "get_labels_histogram",
    "nmi",
    "varinfo",
]
