"""Architecture registry: ``--arch <id>`` resolves here."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, shape_applicable

from repro_torch.configs.internvl2_26b import CONFIG as _internvl2
from repro_torch.configs.command_r_35b import CONFIG as _command_r
from repro_torch.configs.granite_3_2b import CONFIG as _granite3
from repro_torch.configs.granite_8b import CONFIG as _granite8
from repro_torch.configs.llama3_2_3b import CONFIG as _llama32
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2

ARCHS = {c.name: c for c in [
    _internvl2, _command_r, _granite3, _granite8, _llama32,
    _qwen2moe, _qwen3moe, _seamless, _zamba2, _mamba2,
]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "shape_applicable"]
