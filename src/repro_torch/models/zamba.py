"""Zamba2 hybrid: a Mamba2 backbone with ONE shared attention+MLP block
applied after every ``attn_period`` layers (weight sharing; the port of
``repro/models/zamba.py``).

zamba2-2.7b: 54 Mamba2 layers in 9 groups of 6; after each group the shared
transformer block runs (the same weights every time, its own KV cache per
application). ``params["layers"]`` is a list of the Mamba2 layers, layer i
being slot i % period of group i // period (the reference stacks them
[n_groups, period, ...]); ``params["shared"]`` is the shared block. The
shared attention goes through the flash kernel under ``attn_impl="flash"``
(causal, dh 80 at full width).

The cache, each leaf with a leading [n_groups] dim: the shared block's
"k"/"v" [g, B, clen, KH, dh], clen = min(shared_attn_window, max_len), a
ring buffer when clen is the window; per slot j of the period the Mamba2
states "ssm{j}" [g, B, H, N, 64] (f32) and "conv{j}" [g, B, k - 1, C] (the
reference's tuples, flattened as the dense family names "k{j}").

Over a model axis (``tp``) the Mamba2 layers split their heads
(``ssm``), the shared block splits as ``attention`` and ``mlp`` state, the
tied embedding holds this rank's vocabulary rows and the logits are
gathered whole; the group loop is unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from .attention import attention_block, decode_attention, init_attention, \
    kv_policy
from .common import TP, TP1, ParamBuilder, chunked_cross_entropy, \
    embed_lookup, rms_norm
from .mlp import init_mlp, mlp_block
from .ssm import init_mamba2, mamba2_block, mamba2_decode
from .transformer import seq_slots


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.attn_period:
        raise ValueError(f"{cfg.n_layers} layers do not group by "
                         f"{cfg.attn_period}")
    return cfg.n_layers // cfg.attn_period


def init_zamba(cfg: ModelConfig, generator: torch.Generator,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Parameters drawn from ``generator`` with the reference's scales: the
    Mamba2 layers (``init_mamba2`` and a pre-norm "ln"), the shared block
    (attention, SwiGLU MLP, "ln1"/"ln2"), the tied embedding x
    d_model^-1/2 and "final_norm"."""
    _n_groups(cfg)
    layers = []
    for _ in range(cfg.n_layers):
        b = ParamBuilder(generator, dtype, device)
        init_mamba2(b, cfg)
        b.ones("ln", (cfg.d_model,))
        layers.append(b.params)
    sb = ParamBuilder(generator, dtype, device)      # the ONE shared block
    init_attention(sb, cfg)
    init_mlp(sb, cfg.d_model, cfg.d_ff)
    sb.ones("ln1", (cfg.d_model,))
    sb.ones("ln2", (cfg.d_model,))
    b = ParamBuilder(generator, dtype, device)
    b.dense("embed", (cfg.vocab_size, cfg.d_model), scale=cfg.d_model ** -0.5)
    b.ones("final_norm", (cfg.d_model,))
    return {**b.params, "layers": layers, "shared": sb.params}


def _group_fwd(x, group, shared, cfg: ModelConfig, collect_state: bool,
               tp: TP = TP1):
    """One group: its Mamba2 layers, then the shared block. Returns (x,
    [(ssm, conv) per slot], (k, v)) (the states None unless
    ``collect_state``)."""
    states = []
    for pj in group:
        h = mamba2_block(pj, rms_norm(x, pj["ln"]), cfg,
                         return_state=collect_state, tp=tp)
        if collect_state:
            h, st = h
            states.append(st)
        x = x + h
    a, kv = attention_block(shared, rms_norm(x, shared["ln1"]), cfg,
                            window=None, tp=tp)
    x = x + a
    x = x + mlp_block(shared, rms_norm(x, shared["ln2"]), tp=tp)
    return x, states, kv


def forward(params, tokens, cfg: ModelConfig, *, remat: bool = True,
            collect_state: bool = False, tp: TP = TP1):
    """Full-sequence forward. Returns (hidden [B, S, D], per group
    ([(ssm, conv) per slot], (k, v)) when ``collect_state``, else None).
    ``remat`` recomputes each group in the backward pass from the residual
    stream at its start (the reference's ``jax.checkpoint`` on its scanned
    group)."""
    if remat and collect_state:
        raise ValueError("remat recomputes the groups' states; it does not "
                         "collect them")
    period = cfg.attn_period
    x = embed_lookup(params["embed"], tokens, tp)
    shared, layers = params["shared"], params["layers"]
    states = []
    for g0 in range(0, len(layers), period):
        group = layers[g0:g0 + period]
        if remat:
            x = checkpoint(lambda x, group=group: _group_fwd(
                x, group, shared, cfg, False, tp)[0], x,
                use_reentrant=False)
        else:
            x, st, kv = _group_fwd(x, group, shared, cfg, collect_state, tp)
            states.append((st, kv))
    x = rms_norm(x, params["final_norm"])
    return x, (states if collect_state else None)


def lm_loss(params, batch, cfg: ModelConfig, *,
            remat: bool = True, tp: TP = TP1) -> torch.Tensor:
    """Mean next-token CE of ``batch`` ({"tokens", "labels"} [B, S]; labels
    of -1 are padding) against the tied embedding."""
    hidden, _ = forward(params, batch["tokens"], cfg, remat=remat, tp=tp)
    b, s, d = hidden.shape
    return chunked_cross_entropy(hidden.reshape(b * s, d), params["embed"],
                                 batch["labels"].reshape(b * s), tp=tp)


def _logits(params, hidden_last, tp: TP = TP1):
    return tp.gather((hidden_last @ params["embed"].T.to(
        hidden_last.dtype)).to(torch.float32), -1)


def prefill(params, tokens, cfg: ModelConfig, *, max_len: int | None = None,
            tp: TP = TP1):
    """Run the prompt, return (cache, last-token logits [B, V] f32). The
    shared block's K/V keep clen = min(shared_attn_window, max_len) rows:
    the last clen positions rolled so that position p sits in row p % clen
    when the prompt is longer, zero-padded when shorter. Cache leaves are
    in the parameters' dtype, the ssm states f32."""
    s = tokens.shape[1]
    max_len = max_len or s
    hidden, groups = forward(params, tokens, cfg, remat=False,
                             collect_state=True, tp=tp)
    k = torch.stack([kv[0] for _, kv in groups])       # [g, B, S, KH, dh]
    v = torch.stack([kv[1] for _, kv in groups])
    clen = min(cfg.shared_attn_window, max_len)
    if clen < s:
        k = torch.roll(k[:, :, -clen:], s % clen, dims=2)
        v = torch.roll(v[:, :, -clen:], s % clen, dims=2)
    elif clen > s:
        pad = (0, 0, 0, 0, 0, clen - s)
        k, v = F.pad(k, pad), F.pad(v, pad)
    cache = {"k": seq_slots(k, 2, cfg, tp), "v": seq_slots(v, 2, cfg, tp)}
    for j in range(cfg.attn_period):
        cache[f"ssm{j}"] = torch.stack([st[j][0] for st, _ in groups])
        cache[f"conv{j}"] = torch.stack([st[j][1] for st, _ in groups])
    return cache, _logits(params, hidden[:, -1], tp)


def decode_step(params, cache, token, pos, cfg: ModelConfig,
                tp: TP = TP1):
    """One token for the whole stack. token: [B]; pos: a scalar or a
    per-slot [B] vector. Writes the new K/V rows and every Mamba2 state
    into ``cache`` in place, each in its leaf's dtype. The shared
    attention reads its cache as a ring only when it holds
    ``shared_attn_window`` rows (the reference's test; a ``seq`` cache
    padded to a multiple of the model axis may hold more, and a cache
    shorter than the window never wraps, so either reads alike). Returns
    (logits [B, V] f32, cache)."""
    period = cfg.attn_period
    x = embed_lookup(params["embed"], token[:, None], tp)   # [B, 1, D]
    shared, layers = params["shared"], params["layers"]
    rows = cache["k"].shape[2]       # this rank's slots under ``seq``
    if tp.size > 1 and kv_policy(cfg, tp.size) == "seq":
        rows *= tp.size              # the whole cache, a pad included
    window = cfg.shared_attn_window \
        if rows >= cfg.shared_attn_window else None
    for i, pj in enumerate(layers):
        g, j = divmod(i, period)
        ssm, conv = cache[f"ssm{j}"][g], cache[f"conv{j}"][g]
        h, (ssm_new, conv_new) = mamba2_decode(pj, rms_norm(x, pj["ln"]),
                                               (ssm, conv), cfg, tp=tp)
        ssm.copy_(ssm_new)
        conv.copy_(conv_new)
        x = x + h
        if j == period - 1:
            a, _, _ = decode_attention(shared, rms_norm(x, shared["ln1"]),
                                       cache["k"][g], cache["v"][g], pos,
                                       cfg, window=window, tp=tp)
            x = x + a
            x = x + mlp_block(shared, rms_norm(x, shared["ln2"]), tp=tp)
    x = rms_norm(x, params["final_norm"])
    return _logits(params, x[:, 0], tp), cache
