"""NMF solvers: single-problem references, batched drivers, kernels."""

from . import beta, cnmf
from .batch import (
    beta_mu_iterations_batch,
    cd_iterations_batch,
    fit_cd_batch,
    fit_mu_batch,
    fit_mu_beta_batch,
    init_batch,
    mu_iterations_batch,
    pad_and_stack,
    vaf_batch,
)
from .beta import BetaState, beta_divergence, fit_mu_beta, mu_update_beta
from .cnmf import (
    CNMFState,
    TimeVaryingSynergyResult,
    cnmf_iterations_batch,
    cnmf_reconstruct,
    cnmf_update,
    fit_cnmf,
    fit_cnmf_batch,
    init_cnmf,
    normalize_synergies,
)
from .hals import CDState, cd_pass, fit_cd
from .init import initialize_nmf, nndsvd
from .mu import EPSILON, MUState, fit_mu, frobenius_error, mu_update
from .rsvd import initialize_nmf_sklearn, randomized_svd
from .select import NMFModel, SynergyRunResult, compute_regularization, find_synergies

__all__ = [
    "BetaState",
    "CDState",
    "CNMFState",
    "EPSILON",
    "MUState",
    "NMFModel",
    "SynergyRunResult",
    "TimeVaryingSynergyResult",
    "beta",
    "beta_divergence",
    "beta_mu_iterations_batch",
    "cd_iterations_batch",
    "cd_pass",
    "cnmf",
    "cnmf_iterations_batch",
    "cnmf_reconstruct",
    "cnmf_update",
    "compute_regularization",
    "fit_cd",
    "fit_cd_batch",
    "fit_cnmf",
    "fit_cnmf_batch",
    "fit_mu",
    "fit_mu_batch",
    "fit_mu_beta",
    "fit_mu_beta_batch",
    "find_synergies",
    "frobenius_error",
    "init_batch",
    "init_cnmf",
    "initialize_nmf",
    "initialize_nmf_sklearn",
    "mu_iterations_batch",
    "mu_update",
    "mu_update_beta",
    "nndsvd",
    "normalize_synergies",
    "pad_and_stack",
    "randomized_svd",
    "vaf_batch",
]
