"""LM architecture registry of the port: ``qwen2-1.5b``,
``h2o-danube-1.8b``, ``olmo-1b``, ``mamba2-130m`` and ``mixtral-8x22b``;
the reference's other architectures raise ``NotImplementedError`` naming
their ``ROADMAP.md`` item.  The paper's own DSCEP deployment presets are in
:mod:`repro_torch.configs.dscep`."""
from . import (  # noqa: F401
    h2o_danube_1_8b, mamba2_130m, mixtral_8x22b, olmo_1b, qwen2_1_5b)
from .base import ModelConfig, get_config, registered, smoke_variant  # noqa: F401
