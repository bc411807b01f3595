"""Parameter declarations (`ParamDef`) and their initialisation; the mesh mapping waits for the sharding slice."""
from repro_torch.sharding.rules import ParamDef, init_from_defs

__all__ = ["ParamDef", "init_from_defs"]
