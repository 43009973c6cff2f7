"""Architecture registry: ``--arch <id>`` resolves here (a copy of
``repro/configs/__init__.py``'s ``ARCHS`` and ``get_arch``)."""
from . import (chameleon_34b, gemma2_2b, grok1_314b, internlm2_20b, olmo_1b,
               qwen3_32b, qwen3_moe_235b, rwkv6_7b, seamless_m4t_medium,
               zamba2_2p7b)
from .base import ModelConfig, ShapeConfig, TrainConfig

ARCHS = {
    "qwen3-32b": qwen3_32b,
    "internlm2-20b": internlm2_20b,
    "gemma2-2b": gemma2_2b,
    "olmo-1b": olmo_1b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "grok-1-314b": grok1_314b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "chameleon-34b": chameleon_34b,
    "zamba2-2.7b": zamba2_2p7b,
    "rwkv6-7b": rwkv6_7b,
}


def get_arch(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    mod = ARCHS[name]
    return mod.SMOKE if smoke else mod.FULL


__all__ = ["ARCHS", "ModelConfig", "ShapeConfig", "TrainConfig", "get_arch"]
