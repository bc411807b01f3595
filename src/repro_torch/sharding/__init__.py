"""Parameter declarations (`ParamDef`), their initialisation, and the
logical-axis rules that map them onto a mesh."""
from repro_torch.sharding.rules import (
    ParamDef,
    DEFAULT_RULES,
    NamedSharding,
    PartitionSpec,
    logical_to_pspec,
    layer_axes_strs,
    defs_to_shardings,
    init_from_defs,
    batch_pspec,
    act_sharding_constraint,
)

__all__ = [
    "ParamDef",
    "DEFAULT_RULES",
    "NamedSharding",
    "PartitionSpec",
    "logical_to_pspec",
    "layer_axes_strs",
    "defs_to_shardings",
    "init_from_defs",
    "batch_pspec",
    "act_sharding_constraint",
]
