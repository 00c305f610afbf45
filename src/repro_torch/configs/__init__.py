"""Architecture configs of the port; ``get_config(name)`` resolves an id."""
from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      get_smoke_config)
