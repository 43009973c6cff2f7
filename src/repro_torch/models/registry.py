"""Uniform model API, input and cache specs (the port of
``repro/models/registry.py``, every family of the LM zoo: dense, moe,
encdec, hybrid, ssm).

``get_model(cfg, device=)`` returns a ``ModelAPI`` whose members close over
the config and the device:

  init(seed=0, dtype=torch.bfloat16)        -> params, drawn on the device
  loss(params, batch, *, remat=True)        -> scalar CE (f32)
  prefill(params, batch, *, max_len=None)   -> (cache, last-token logits)
  decode(params, cache, token, pos)         -> (logits, cache)
  input_specs(shape)                        -> {name: (shape, dtype)}
  cache_specs(shape, dtype=bf16)            -> {name: (shape, dtype)}

The encdec batch also holds ``frames`` [B, S_enc, D] (the speech
frontend's stub embeddings). Each cache leaf has its own dtype: K/V bf16
whatever the parameters are; the recurrent SSM and wkv states f32
(rounding them to bf16 on every decode tick would drift); the conv and
token-shift states (activation rows) in the parameters' dtype ``dtype``,
bf16 unless the weights are f32 (the reference's spec says bf16, and its
engine holds them in the activations' dtype from its first decode tick
on: its functional update promotes them).

The reference's ``batch_partition`` and the partition specs of its cache
and parameter trees have no counterpart: the port's models run on one
card (``launch.train --mesh Dx1`` replicates them and splits the
batch).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import FLASH_NO_GRAD
from . import encdec, rwkv, transformer, zamba
from .rwkv import rwkv_dims
from .ssm import ssm_dims
from .transformer import _cache_len, _layer_kinds

CACHE_DTYPE = torch.bfloat16   # K/V, whatever the parameters are
STATE_DTYPE = torch.float32    # the recurrent SSM and wkv states


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


def _input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch a shape feeds, {name: (shape, dtype)}: tokens and labels
    [B, S] int32 to train, tokens [B, S] to prefill, one token [B] and a
    scalar position to decode. The encdec family adds bf16 ``frames`` [B,
    S, D] to train and prefills from frames [B, S, D] and one decoder
    token [B, 1]."""
    b, s = shape.global_batch, shape.seq_len
    tok = ((b, s), torch.int32)
    frames = ((b, s, cfg.d_model), torch.bfloat16)
    if shape.kind == "train":
        batch = {"tokens": tok, "labels": tok}
        if cfg.family == "encdec":
            batch["frames"] = frames
        return batch
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": frames, "tokens": ((b, 1), torch.int32)}
        return {"tokens": tok}
    return {"token": ((b,), torch.int32), "pos": ((), torch.int32)}


def _cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """{leaf: (shape, dtype)} of a family's cache at B = global_batch and
    S = seq_len (the reference's ``cache_specs``) for parameters of
    ``dtype``; "conv{j}", "tm_x" and "cm_x" take promote(bf16, dtype):
      dense/moe: "k{j}", "v{j}" [n_groups, B, S, KH, dh] for each slot j of
                 the layer period (local layers: min(window, S) rows);
      encdec:    "k", "v", "xk", "xv" [n_dec_layers, B, S, KH, dh];
      hybrid:    "k", "v" [n_groups, B, min(shared_attn_window, S), KH,
                 dh], and per slot j "ssm{j}" [n_groups, B, H, N, 64] f32,
                 "conv{j}" [n_groups, B, conv_kernel - 1, C];
      ssm:       "tm_x", "cm_x" [L, B, D], "wkv" [L, B, H, 64, 64] f32."""
    b, s = shape.global_batch, shape.seq_len
    kh, dh = cfg.n_kv_heads, cfg.d_head
    rows = torch.promote_types(CACHE_DTYPE, dtype)
    if cfg.family in ("dense", "moe"):
        kinds = _layer_kinds(cfg)
        g = cfg.n_layers // len(kinds)
        specs = {}
        for j, kind in enumerate(kinds):
            spec = ((g, b, _cache_len(cfg, kind, s), kh, dh), CACHE_DTYPE)
            specs[f"k{j}"] = specs[f"v{j}"] = spec
        return specs
    if cfg.family == "encdec":
        kv = ((cfg.n_dec_layers, b, s, kh, dh), CACHE_DTYPE)
        return {"k": kv, "v": kv, "xk": kv, "xv": kv}
    if cfg.family == "hybrid":
        g, period = cfg.n_layers // cfg.attn_period, cfg.attn_period
        _, n_heads, conv_dim = ssm_dims(cfg)
        kv = ((g, b, min(cfg.shared_attn_window, s), kh, dh), CACHE_DTYPE)
        specs = {"k": kv, "v": kv}
        for j in range(period):
            specs[f"ssm{j}"] = ((g, b, n_heads, cfg.ssm_state, 64),
                                STATE_DTYPE)
            specs[f"conv{j}"] = ((g, b, cfg.conv_kernel - 1, conv_dim),
                                 rows)
        return specs
    if cfg.family == "ssm":
        l, d = cfg.n_layers, cfg.d_model
        x = ((l, b, d), rows)
        return {"tm_x": x, "cm_x": x,
                "wkv": ((l, b, rwkv_dims(cfg), 64, 64), STATE_DTYPE)}
    raise ValueError(cfg.family)


#: family -> (init, loss, decode_step) over (cfg, generator, dtype,
#: device), (params, batch, cfg, remat=) and (params, cache, token, pos,
#: cfg)
_FAMILIES = {
    "dense": (transformer.init_lm, transformer.lm_loss,
              transformer.decode_step),
    "moe": (transformer.init_lm, transformer.lm_loss,
            transformer.decode_step),
    "encdec": (encdec.init_encdec, encdec.seq2seq_loss, encdec.decode_step),
    "hybrid": (zamba.init_zamba, zamba.lm_loss, zamba.decode_step),
    "ssm": (rwkv.init_rwkv_lm, rwkv.lm_loss, rwkv.decode_step),
}


def get_model(cfg: ModelConfig, *, device=None) -> ModelAPI:
    """The model API on ``device`` (``None``: the GPU, raising without
    one)."""
    fam = cfg.family
    if fam not in _FAMILIES:
        raise ValueError(fam)
    dev = resolve_device(device)
    init_fn, loss_fn, decode_fn = _FAMILIES[fam]

    def init(seed: int = 0, dtype: torch.dtype = torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_fn(cfg, gen, dtype, dev)

    def loss(params, batch, *, remat=True):
        # the flash kernel is forward only; RWKV attends nothing
        if cfg.attn_impl == "flash" and fam != "ssm":
            raise RuntimeError(f"{cfg.name}: {FLASH_NO_GRAD}")
        return loss_fn(params, batch, cfg, remat=remat)

    def prefill(params, batch, *, max_len=None):
        if fam == "encdec":
            return encdec.prefill(
                params, batch["frames"], batch["tokens"], cfg,
                max_len=max_len or batch["frames"].shape[1])
        if fam == "hybrid":
            return zamba.prefill(params, batch["tokens"], cfg,
                                 max_len=max_len)
        if fam == "ssm":       # the state is whole at any length
            return rwkv.prefill(params, batch["tokens"], cfg)
        return transformer.prefill(params, batch["tokens"], cfg,
                                   max_len=max_len)

    def decode(params, cache, token, pos):
        return decode_fn(params, cache, token, pos, cfg)

    return ModelAPI(cfg=cfg, device=dev, init=init, loss=loss,
                    prefill=prefill, decode=decode,
                    input_specs=lambda shape: _input_specs(cfg, shape),
                    cache_specs=lambda shape, dtype=torch.bfloat16:
                    _cache_specs(cfg, shape, dtype))
