"""Uniform model API, input and cache specs (the port of
``repro/models/registry.py``, every family of the LM zoo: dense, moe,
encdec, hybrid, ssm).

``get_model(cfg, tp_size=, dp_size=, mesh=, device=)`` returns a
``ModelAPI`` whose members close over the config, the device and the model
axis:

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

Tensor parallelism: with ``tp_size`` M > 1 every family splits over the
``model`` axis of ``mesh`` (a DeviceMesh with axes (data, model), or
(pod, data, model)), Megatron-style (``models/common.py``). ``init``
draws the whole parameters from the seed and keeps this rank's cut
(``convert.shard_lm``), so rank r holds exactly the world-1 run's slice;
``cache_specs`` gives this rank's leaf shapes
under the reference's ``_kv_policy`` (``attention.kv_policy``); prefill
and decode return the logits whole on every rank. ``dp_size`` is the
product of the mesh's data axes (``distributed.mesh.data_axes``), which
the launcher splits batches over (the data-parallel run replicates the
parameters: no FSDP). The port splits attention's query heads, Mamba2's
heads and RWKV6's heads by whole heads when M divides them, and each
head over M / H ranks (mid-head, as the reference's GSPMD splits the
same column blocks) when they divide M and M / H divides the head's
channels (``check_heads``); any other pair is refused by a
``ValueError`` (``HEADS_DO_NOT_SPLIT``). The reference's
``batch_partition`` has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import data_axes
from repro_torch.kernels.ops import FLASH_NO_GRAD
from . import encdec, rwkv, transformer, zamba
from .attention import kv_policy
from .common import TP, TP1
from .rwkv import rwkv_dims
from .ssm import ssm_dims
from .transformer import _cache_len, _layer_kinds

#: why a model axis that neither rule of ``check_heads`` covers is refused
HEADS_DO_NOT_SPLIT = ("{n} {what} of {width} channels do not split over a "
                      "model axis of {m}: the port splits whole heads (M "
                      "divides the heads) or each head over M / heads ranks "
                      "(the heads divide M, and M / heads divides a head's "
                      "channels)")

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
    tp: TP = TP1


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
                 dtype: torch.dtype = torch.bfloat16, tp: TP = TP1) -> dict:
    """{leaf: (shape, dtype)} of a family's cache at B = global_batch and
    S = seq_len (the reference's ``cache_specs``) for parameters of
    ``dtype``; "conv{j}", "tm_x" and "cm_x" take promote(bf16, dtype):
      dense/moe: "k{j}", "v{j}" [n_groups, B, S, KH, dh] for each slot j of
                 the layer period (local layers: min(window, S) rows);
      encdec:    "k", "v", "xk", "xv" [n_dec_layers, B, S, KH, dh];
      hybrid:    "k", "v" [n_groups, B, min(shared_attn_window, S), KH,
                 dh], and per slot j "ssm{j}" [n_groups, B, H, N, 64] f32,
                 "conv{j}" [n_groups, B, conv_kernel - 1, C];
      ssm:       "tm_x", "cm_x" [L, B, D], "wkv" [L, B, H, 64, 64] f32.
    Under ``tp`` of M ranks these are one rank's: K/V with KH/M heads
    (``heads`` policy) or ceil(S/M) rows (``seq``; the encdec's cross
    cache S/M exactly), the hybrid's ssm states with H/M heads and its
    conv rows with d_inner/M + 2 N channels, RWKV6's wkv state with H/M
    heads and its token-shift rows whole; under a mid-head split the ssm
    and wkv states hold one head's 64 / r channels."""
    b, s = shape.global_batch, shape.seq_len
    kh, dh = cfg.n_kv_heads, cfg.d_head
    rows = torch.promote_types(CACHE_DTYPE, dtype)

    def kv(clen, pad=True):    # a padded self cache, an exact cross one
        if tp.size > 1 and kv_policy(cfg, tp.size) == "seq":
            return (-(-clen // tp.size) if pad
                    else tp.local(clen, "cache rows")), kh
        return clen, tp.local(kh, "kv heads")

    if cfg.family in ("dense", "moe"):
        kinds = _layer_kinds(cfg)
        g = cfg.n_layers // len(kinds)
        specs = {}
        for j, kind in enumerate(kinds):
            spec = ((g, b, *kv(_cache_len(cfg, kind, s)), dh), CACHE_DTYPE)
            specs[f"k{j}"] = specs[f"v{j}"] = spec
        return specs
    if cfg.family == "encdec":
        self_kv = ((cfg.n_dec_layers, b, *kv(s), dh), CACHE_DTYPE)
        cross = ((cfg.n_dec_layers, b, *kv(s, pad=False), dh), CACHE_DTYPE)
        return {"k": self_kv, "v": self_kv, "xk": cross, "xv": cross}
    if cfg.family == "hybrid":
        g, period = cfg.n_layers // cfg.attn_period, cfg.attn_period
        d_inner, n_heads, conv_dim = ssm_dims(cfg)
        r = tp.group(n_heads)        # mid-head: one head's 64 / r channels
        n_heads = tp.local(n_heads, "Mamba2 heads") if r == 1 else 1
        conv_dim -= d_inner - d_inner // tp.size
        kvs = ((g, b, *kv(min(cfg.shared_attn_window, s)), dh), CACHE_DTYPE)
        specs = {"k": kvs, "v": kvs}
        for j in range(period):
            specs[f"ssm{j}"] = ((g, b, n_heads, cfg.ssm_state, 64 // r),
                                STATE_DTYPE)
            specs[f"conv{j}"] = ((g, b, cfg.conv_kernel - 1, conv_dim),
                                 rows)
        return specs
    if cfg.family == "ssm":     # the token-shift rows whole on every rank
        l, d = cfg.n_layers, cfg.d_model
        x = ((l, b, d), rows)
        r = tp.group(rwkv_dims(cfg))     # mid-head: one head's 64 / r values
        heads = tp.local(rwkv_dims(cfg), "RWKV6 heads") if r == 1 else 1
        return {"tm_x": x, "cm_x": x,
                "wkv": ((l, b, heads, 64, 64 // r), STATE_DTYPE)}
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


def _model_axis(cfg: ModelConfig, tp_size: int, dp_size: int, mesh) -> TP:
    """The TP context of ``mesh``, checked against ``tp_size``, ``dp_size``
    (the product of the mesh's data axes) and the config's heads."""
    if mesh is None:
        if tp_size > 1:
            raise ValueError(f"tp_size={tp_size} needs a mesh with a model "
                             f"axis of {tp_size} ranks")
        return TP1
    tp = TP.of(mesh)
    _, data = data_axes(mesh)
    if (tp.size, data) != (tp_size, dp_size):
        raise ValueError(f"tp_size={tp_size}, dp_size={dp_size}, but the "
                         f"mesh's model and data axes have {tp.size} and "
                         f"{data} ranks")
    check_heads(cfg, tp.size)
    return tp


def check_heads(cfg: ModelConfig, m: int) -> None:
    """Raise ``HEADS_DO_NOT_SPLIT`` unless a model axis of ``m`` splits
    every head count of ``cfg`` (RWKV6's, or the query heads and the
    hybrid's Mamba2 heads) by whole heads (m divides it) or mid-head (it
    divides m, and m / heads divides a head's channels)."""
    heads = [(rwkv_dims(cfg), 64, "RWKV6 heads")] if cfg.family == "ssm" \
        else [(cfg.n_heads, cfg.d_head, "query heads")]
    if cfg.family == "hybrid":
        heads.append((ssm_dims(cfg)[1], 64, "Mamba2 heads"))
    for n, width, what in heads:
        if n % m and (m % n or width % (m // n)):
            raise ValueError(HEADS_DO_NOT_SPLIT.format(
                n=n, what=what, width=width, m=m))


def get_model(cfg: ModelConfig, *, tp_size: int = 1, dp_size: int = 1,
              mesh=None, device=None) -> ModelAPI:
    """The model API on ``device`` (``None``: the GPU, raising without
    one), split over the ``model`` axis of ``mesh`` when ``tp_size`` > 1
    (a mesh whose model axis has one rank runs the same code with every
    collective the identity)."""
    fam = cfg.family
    if fam not in _FAMILIES:
        raise ValueError(fam)
    dev = resolve_device(device)
    tp = _model_axis(cfg, tp_size, dp_size, mesh)
    init_fn, loss_fn, decode_fn = _FAMILIES[fam]

    def init(seed: int = 0, dtype: torch.dtype = torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_fn(cfg, gen, dtype, dev)
        if tp.size > 1:
            from repro_torch.convert import shard_lm
            params = shard_lm(params, cfg, tp.rank, tp.size)
        return params

    def loss(params, batch, *, remat=True):
        # the flash kernel is forward only; RWKV attends nothing
        if cfg.attn_impl == "flash" and fam != "ssm":
            raise RuntimeError(f"{cfg.name}: {FLASH_NO_GRAD}")
        return loss_fn(params, batch, cfg, remat=remat, tp=tp)

    def prefill(params, batch, *, max_len=None):
        if fam == "encdec":
            return encdec.prefill(
                params, batch["frames"], batch["tokens"], cfg,
                max_len=max_len or batch["frames"].shape[1], tp=tp)
        if fam == "hybrid":
            return zamba.prefill(params, batch["tokens"], cfg,
                                 max_len=max_len, tp=tp)
        if fam == "ssm":       # the state is whole at any length
            return rwkv.prefill(params, batch["tokens"], cfg, tp=tp)
        return transformer.prefill(params, batch["tokens"], cfg,
                                   max_len=max_len, tp=tp)

    def decode(params, cache, token, pos):
        return decode_fn(params, cache, token, pos, cfg, tp=tp)

    return ModelAPI(cfg=cfg, device=dev, init=init, loss=loss,
                    prefill=prefill, decode=decode,
                    input_specs=lambda shape: _input_specs(cfg, shape),
                    cache_specs=lambda shape, dtype=torch.bfloat16:
                    _cache_specs(cfg, shape, dtype, tp), tp=tp)
