"""Tensor, data, sequence and expert parallelism over ``torch.distributed``
(the counterpart of ``gear_tpu/parallel``): ``distributed`` (process groups,
the named :class:`~gear_tpu_torch.parallel.distributed.Mesh`, its
collectives), ``sharding`` (tensor and data parallelism), ``context``
(sequence parallelism over the compressed cache). Expert parallelism is
``models.mixtral.moe_block_ep``."""
from . import context, distributed, sharding  # noqa: F401
