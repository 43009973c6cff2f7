"""GQA attention: the training / prefill path (the flash kernel or chunked
attention), the decode path over a per-slot KV cache, and the
encoder-decoder's cross-attention over the encoder's K/V (the port of
``repro/models/attention.py``).

The reference's decode KV-cache sharding policy belongs to the mesh slice;
the port runs on one card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .common import NEG_INF, ParamBuilder, apply_rope, chunked_attention, \
    rms_norm


def init_attention(b: ParamBuilder, cfg: ModelConfig, prefix: str = ""):
    """Add attention params (wq [D, H*dh], wk/wv [D, KH*dh], wo [H*dh, D],
    and qn/kn [dh] under qk_norm) to a ParamBuilder ``b``."""
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b.dense(prefix + "wq", (d, h * dh))
    b.dense(prefix + "wk", (d, kh * dh))
    b.dense(prefix + "wv", (d, kh * dh))
    b.dense(prefix + "wo", (h * dh, d))
    if cfg.qk_norm:
        b.ones(prefix + "qn", (dh,))
        b.ones(prefix + "kn", (dh,))


def _project_qkv(p, x, cfg: ModelConfig, positions, prefix=""):
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p[prefix + "wq"]).reshape(b, s, h, dh)
    k = (x @ p[prefix + "wk"]).reshape(b, s, kh, dh)
    v = (x @ p[prefix + "wv"]).reshape(b, s, kh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p[prefix + "qn"])
        k = rms_norm(k, p[prefix + "kn"])
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def attention_block(p, x, cfg: ModelConfig, *, window: int | None,
                    causal: bool = True, positions=None, prefix: str = "",
                    q_chunk: int = 512):
    """Full-sequence attention (training / prefill). Returns (out, (k, v)).

    ``attn_impl="flash"`` on a layer without a window goes through
    ``ops.flash_attention`` — the CUDA kernel for a tensor on the card, its
    plain version on the CPU; it is forward only and raises when a
    gradient would flow through it. Every other layer takes chunked
    attention."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, prefix)
    if cfg.attn_impl == "flash" and window is None:
        # [B, S, H, dh] -> [B, H, S, dh] views and back: the kernel reads
        # and writes them in place
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, softcap=cfg.attn_softcap).transpose(1, 2)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                attn_softcap=cfg.attn_softcap,
                                q_chunk=q_chunk)
    out = out.reshape(b, s, cfg.n_heads * cfg.d_head)
    return out @ p[prefix + "wo"], (k, v)


def cross_attention_block(p, x, memory_kv, cfg: ModelConfig, *,
                          prefix: str = "x_"):
    """Decoder cross-attention against precomputed encoder (k, v) [B, Sm,
    KH, dh]: chunked attention, not causal, no RoPE on q (the reference
    sends it through no kernel)."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    q = (x @ p[prefix + "wq"]).reshape(b, s, h, dh)
    k, v = memory_kv
    out = chunked_attention(q, k, v, causal=False, window=None,
                            attn_softcap=cfg.attn_softcap)
    return out.reshape(b, s, h * dh) @ p[prefix + "wo"]


def decode_attention(p, x, cache_k, cache_v, pos, cfg: ModelConfig, *,
                     window: int | None = None, prefix: str = ""):
    """One-token decode: write the new K/V at ``pos``, attend over the cache.

    x: [B, 1, D]; cache_k/v: [B, S, KH, dh] (a ring buffer when ``window``).
    ``pos`` is a scalar or a per-slot [B] vector (continuous batching: each
    slot sits at its own cursor). The reference returns new cache arrays;
    the port writes the new rows into ``cache_k``/``cache_v`` in place
    (rounded to the cache's dtype), so the serving engine keeps one cache
    allocation. Returns (out [B, 1, D], cache_k, cache_v)."""
    b = x.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = cache_k.shape[1]
    pos_b = torch.as_tensor(pos, dtype=torch.long,
                            device=x.device).expand(b)            # [B]
    q, k, v = _project_qkv(p, x, cfg, pos_b[:, None], prefix)

    slot_b = pos_b % s if window is not None else pos_b
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot_b] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot_b] = v[:, 0].to(cache_v.dtype)

    # scores over the cache: [B, KH, G, S]
    qg = q.reshape(b, kh, h // kh, dh).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg,
                          cache_k.to(torch.float32)) * dh ** -0.5
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    kpos = torch.arange(s, device=x.device)
    valid = kpos[None, :] <= pos_b[:, None]
    if window is not None:
        # ring buffer: before wrap-around only slots <= pos hold data; after
        # the first wrap every slot is a live (windowed) entry.
        valid = valid | (pos_b[:, None] >= s)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cache_v.to(torch.float32))
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return out @ p[prefix + "wo"], cache_k, cache_v


def decode_cross_attention(p, x, memory_kv, cfg: ModelConfig, *,
                           prefix: str = "x_"):
    """One decoder token against the encoder's (k, v) [B, Sm, KH, dh]:
    scores and softmax in f32, every memory row valid. x: [B, 1, D] ->
    [B, 1, D]."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.d_head
    k, v = memory_kv
    kh = k.shape[2]
    qg = (x @ p[prefix + "wq"]).reshape(b, kh, h // kh, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k.to(torch.float32)) * dh ** -0.5
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.to(torch.float32))
    return out.reshape(b, 1, h * dh).to(x.dtype) @ p[prefix + "wo"]
