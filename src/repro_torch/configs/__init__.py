"""LM architecture registry of the port: ``qwen2-1.5b`` and
``mamba2-130m``; the reference's other architectures raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.  The paper's own
DSCEP deployment presets are in :mod:`repro_torch.configs.dscep`."""
from . import mamba2_130m, qwen2_1_5b  # noqa: F401
from .base import ModelConfig, get_config, registered, smoke_variant  # noqa: F401
