"""Parallelism of the port: a ('data',) device mesh and its replicate and
shard helpers (:mod:`.mesh`), process groups for data-parallel training
(:mod:`.distributed`), the halo-exchanged time-sharded featurizer
(:mod:`.halo`) and the executable multi-process check (:mod:`.mp_check`).
The port of ``advoc_tpu.parallel``."""

from advoc_tpu_torch.parallel.mesh import Mesh, data_mesh, replicate, shard_batch

__all__ = ["Mesh", "data_mesh", "replicate", "shard_batch"]
