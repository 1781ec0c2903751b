"""Architecture configurations of the port (see :mod:`.base`)."""

from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, ArchConfig, REGISTRY, get_config, load_all, register)
