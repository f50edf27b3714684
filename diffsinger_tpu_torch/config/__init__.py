from .hparams import load_config, override_config

__all__ = ["load_config", "override_config"]
