"""Architecture registry: one module per assigned architecture (copies of
``repro/configs/<id>.py``)."""

from repro_torch.configs.base import (ArchConfig, LayerSpec, MLASpec, MambaSpec,
                                      MoESpec, get_config, registry)

__all__ = ["ArchConfig", "LayerSpec", "MLASpec", "MambaSpec", "MoESpec",
           "registry", "get_config"]
