"""Parameter declarations (`ParamDef`) and their initialisation; the mesh mapping waits for the sharding slice."""
