"""Hand-written CUDA kernels of the batched solvers and their wrappers.

- :mod:`.mu_cuda`: Frobenius MU (``csrc/mu_nmf.cu``), replacing
  ``mu_iterations_pallas`` / ``fit_mu_pallas``;
- :mod:`.cd_cuda`: HALS/CD (``csrc/cd_nmf.cu``), replacing
  ``cd_iterations_pallas`` / ``fit_cd_pallas``;
- :mod:`.beta_cuda`: beta-divergence MU (``csrc/beta_nmf.cu``),
  replacing ``beta_mu_iterations_pallas`` / ``kl_mu_iterations_pallas``;
- :mod:`.cnmf_cuda`: convolutive NMF (``csrc/cnmf.cu``), replacing
  ``cnmf_iterations_pallas``.

Importing them builds nothing: a kernel is compiled at its first launch
(:mod:`muscle_synergies_tpu_torch._build`).
"""

from . import beta_cuda, cd_cuda, cnmf_cuda, mu_cuda

__all__ = ["beta_cuda", "cd_cuda", "cnmf_cuda", "mu_cuda"]
