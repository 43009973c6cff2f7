"""Uniform model API, input and cache specs (the port of
``repro/models/registry.py``, the ``dense`` and ``moe`` families).

``get_model(cfg, device=)`` returns a ``ModelAPI`` whose members close over
the config and the device:

  init(seed=0, dtype=torch.bfloat16)        -> params, drawn on the device
  loss(params, batch, *, remat=True)        -> scalar CE (f32)
  prefill(params, batch, *, max_len=None)   -> (cache, last-token logits)
  decode(params, cache, token, pos)         -> (logits, cache)
  input_specs(shape)                        -> {name: (shape, dtype)}
  cache_specs(shape)                        -> {name: (shape, dtype)}

The reference's ``batch_partition`` and the partition specs of its cache
and parameter trees have no counterpart: the port's models run on one
card (``launch.train --mesh Dx1`` replicates them and splits the batch).
The encoder-decoder, hybrid and SSM families wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import FLASH_NO_GRAD
from . import transformer
from .transformer import _cache_len, _layer_kinds

#: families not ported yet -> where the ROADMAP queues them
NOT_PORTED = {
    "encdec": "the encoder-decoder family (ROADMAP Queue 1 item 13)",
    "hybrid": "the hybrid SSM family (ROADMAP Queue 1 item 13)",
    "ssm": "the SSM family (ROADMAP Queue 1 item 13)",
}
CACHE_DTYPE = torch.bfloat16   # the KV cache, whatever the parameters are


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    input_specs: Callable[..., Any]
    cache_specs: Callable[..., Any]


def _input_specs(shape: ShapeConfig) -> dict:
    """The batch a shape feeds, {name: (shape, dtype)}: tokens and labels
    [B, S] int32 to train, tokens [B, S] to prefill, one token [B] and a
    scalar position to decode."""
    b, s = shape.global_batch, shape.seq_len
    tok = ((b, s), torch.int32)
    if shape.kind == "train":
        return {"tokens": tok, "labels": tok}
    if shape.kind == "prefill":
        return {"tokens": tok}
    return {"token": ((b,), torch.int32), "pos": ((), torch.int32)}


def _cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{"k{j}", "v{j}"} -> ((n_groups, B, S, KH, dh), bf16) for each slot j
    of the layer period; local layers hold min(window, S) rows."""
    b, s = shape.global_batch, shape.seq_len
    kinds = _layer_kinds(cfg)
    g = cfg.n_layers // len(kinds)
    specs = {}
    for j, kind in enumerate(kinds):
        spec = ((g, b, _cache_len(cfg, kind, s), cfg.n_kv_heads, cfg.d_head),
                CACHE_DTYPE)
        specs[f"k{j}"] = specs[f"v{j}"] = spec
    return specs


def get_model(cfg: ModelConfig, *, device=None) -> ModelAPI:
    """The model API on ``device`` (``None``: the GPU, raising without
    one)."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: {NOT_PORTED[cfg.family]} is not ported to "
            f"repro_torch yet")
    if cfg.family not in ("dense", "moe"):
        raise ValueError(cfg.family)
    dev = resolve_device(device)

    def init(seed: int = 0, dtype: torch.dtype = torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_lm(cfg, gen, dtype, dev)

    def loss(params, batch, *, remat=True, q_chunk=None):
        if cfg.attn_impl == "flash":
            raise RuntimeError(f"{cfg.name}: {FLASH_NO_GRAD}")
        return transformer.lm_loss(params, batch, cfg, remat=remat,
                                   q_chunk=q_chunk)

    def prefill(params, batch, *, max_len=None):
        return transformer.prefill(params, batch["tokens"], cfg,
                                   max_len=max_len)

    def decode(params, cache, token, pos):
        return transformer.decode_step(params, cache, token, pos, cfg)

    return ModelAPI(cfg=cfg, device=dev, init=init, loss=loss,
                    prefill=prefill, decode=decode, input_specs=_input_specs,
                    cache_specs=lambda shape: _cache_specs(cfg, shape))
