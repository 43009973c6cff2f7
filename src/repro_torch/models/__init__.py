"""The LM zoo's decoder families, dense and MoE (the port of
``repro/models``)."""
from .registry import ModelAPI, get_model

__all__ = ["ModelAPI", "get_model"]
