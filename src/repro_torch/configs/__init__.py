"""Architecture registry: ``--arch <id>`` resolves here (a copy of
``repro/configs/__init__.py``'s ``ARCHS``, ``get_arch``,
``LONG_CONTEXT_ARCHS`` and ``cells``)."""
from . import (chameleon_34b, gemma2_2b, grok1_314b, internlm2_20b, olmo_1b,
               qwen3_32b, qwen3_moe_235b, rwkv6_7b, seamless_m4t_medium,
               zamba2_2p7b)
from .base import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                   ModelConfig, ShapeConfig, TrainConfig)

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

# long_500k needs sub-quadratic sequence mixing: only the ssm and hybrid
# families run it (the pure full-attention archs are skipped)
LONG_CONTEXT_ARCHS = {"zamba2-2.7b", "rwkv6-7b"}


def get_arch(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    mod = ARCHS[name]
    return mod.SMOKE if smoke else mod.FULL


def cells(include_long: bool = True):
    """Every (arch, shape) dry-run cell, with the documented skips."""
    out = []
    for arch in ARCHS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if shape == "long_500k" and (arch not in LONG_CONTEXT_ARCHS
                                         or not include_long):
                continue
            out.append((arch, shape))
    return out


__all__ = ["ARCHS", "LONG_CONTEXT_ARCHS", "SHAPES", "ModelConfig",
           "ShapeConfig", "TrainConfig", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K", "get_arch", "cells"]
