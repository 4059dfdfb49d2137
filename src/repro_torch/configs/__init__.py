"""LM architecture registry of the port: ``qwen2-1.5b`` and
``mamba2-130m``; the reference's other architectures raise
``NotImplementedError`` naming their ``ROADMAP.md`` item."""
from . import mamba2_130m, qwen2_1_5b  # noqa: F401
from .base import ModelConfig, get_config, registered, smoke_variant  # noqa: F401
