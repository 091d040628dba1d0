"""Mesh-parallel execution over ``torch.distributed``: sharded NMF and
sequence-parallel filters.

Port of :mod:`muscle_synergies_tpu.parallel`.  A mesh is a
``DeviceMesh`` of processes (:func:`make_mesh`), NCCL on the card and
gloo on the CPU; each sharded function takes plain tensors or DTensors
and returns DTensors placed as the JAX function's ``out_specs``.
"""

from . import collectives
from .filters import sharded_moving_rms, sharded_sosfilt, sharded_sosfiltfilt
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    TIME_AXIS,
    batch_sharding,
    init_distributed,
    make_mesh,
    replicated,
)
from .cnmf import sharded_fit_cnmf, sharded_fit_cnmf_tp
from .nm3f import sharded_fit_nm3f
from .nmf import (
    sharded_fit_beta,
    sharded_fit_cd,
    sharded_fit_kl,
    sharded_fit_mu,
    sharded_fit_mu_tp,
    sharded_mu_step,
)

__all__ = [
    "DATA_AXIS",
    "TIME_AXIS",
    "init_distributed",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "sharded_mu_step",
    "sharded_fit_mu",
    "sharded_fit_beta",
    "sharded_fit_kl",
    "sharded_fit_mu_tp",
    "sharded_fit_cnmf",
    "sharded_fit_cnmf_tp",
    "sharded_fit_nm3f",
    "MODEL_AXIS",
    "sharded_fit_cd",
    "sharded_moving_rms",
    "sharded_sosfilt",
    "sharded_sosfiltfilt",
    "collectives",
]
