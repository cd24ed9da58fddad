"""Distribution layer (port of ``repro.distributed``): the logical-axis
sharding rules on a ``DeviceMesh`` / DTensor (``sharding``) and the
compressed and ring collectives over ``torch.distributed``
(``collectives``), and the split of a step's compute over the ``model``
axis (``tensor_parallel``)."""

from repro_torch.distributed.sharding import NamedSharding, ShardingRules  # noqa: F401
