"""The LM zoo (the port of ``repro/models``): the decoder families dense
and MoE (``transformer``), the encoder-decoder (``encdec``), the hybrid
Mamba2 + shared attention (``zamba`` over ``ssm``) and RWKV6 (``rwkv``),
behind one ``ModelAPI`` (``get_model``)."""
from . import encdec, rwkv, ssm, transformer, zamba
from .registry import ModelAPI, get_model

__all__ = ["ModelAPI", "encdec", "get_model", "rwkv", "ssm", "transformer",
           "zamba"]
