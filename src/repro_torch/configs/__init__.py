"""LM architecture registry of the port: ``qwen2-1.5b``,
``h2o-danube-1.8b``, ``olmo-1b`` and ``mamba2-130m``; the reference's other
architectures raise ``NotImplementedError`` naming their ``ROADMAP.md``
item.  The paper's own DSCEP deployment presets are in
:mod:`repro_torch.configs.dscep`."""
from . import h2o_danube_1_8b, mamba2_130m, olmo_1b, qwen2_1_5b  # noqa: F401
from .base import ModelConfig, get_config, registered, smoke_variant  # noqa: F401
