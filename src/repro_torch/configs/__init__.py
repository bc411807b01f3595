from repro_torch.configs.registry import get_config, list_configs, reduced_config

__all__ = ["get_config", "list_configs", "reduced_config"]
