"""LM architecture registry of the port: ``qwen2-1.5b``,
``h2o-danube-1.8b``, ``olmo-1b``, ``mamba2-130m``, ``mixtral-8x22b``,
``minicpm3-4b``, ``deepseek-v2-236b``, ``jamba-v0.1-52b``,
``qwen2-vl-7b`` and ``musicgen-large``: every architecture the reference
registers.  The paper's own DSCEP deployment presets are in
:mod:`repro_torch.configs.dscep`."""
from . import (  # noqa: F401
    deepseek_v2_236b, h2o_danube_1_8b, jamba_v0_1_52b, mamba2_130m,
    minicpm3_4b, mixtral_8x22b, musicgen_large, olmo_1b, qwen2_1_5b,
    qwen2_vl_7b)
from .base import ModelConfig, get_config, registered, smoke_variant  # noqa: F401
