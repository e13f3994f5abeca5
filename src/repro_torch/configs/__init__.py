"""Architecture configs.  ``get_config(name)`` resolves any assigned
architecture id (plus variants) to a ModelConfig.

A copy of the JAX package's ``repro.configs`` (standard library only),
kept in the port so that the port imports nothing of the JAX package.
Every config registers here, and the port builds and runs each
(``repro_torch.models.transformer``)."""

from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register)

__all__ = ["ModelConfig", "get_config", "list_configs", "register"]
