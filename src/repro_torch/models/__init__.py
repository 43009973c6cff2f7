"""The LM zoo's dense decoder family (the port of ``repro/models``)."""
from .registry import ModelAPI, get_model

__all__ = ["ModelAPI", "get_model"]
