"""Decoder-only LM family: qwen3 / internlm2 / gemma2 / olmo / qwen3-moe /
grok-1 / chameleon (the port of ``repro/models/transformer.py``).

The reference stacks layers [n_groups, period, ...] and scans over groups
(period 2 for gemma2's local/global alternation, else 1). The port keeps
``params["layers"]`` as a list of per-layer dicts, layer i being slot
i % period of group i // period, and loops over it. The KV cache keeps the
reference's layout: ``{"k{j}", "v{j}"}`` for each slot j of the period,
each [n_groups, B, S, KH, dh]. A config with ``n_experts`` takes the MoE
(``mlp.moe_block``) in place of the dense FFN. Remat (``forward(remat=
True)``, ``lm_loss``) checkpoints each layer group: only the residual
stream at group boundaries is saved, as the reference's
``jax.checkpoint(..., nothing_saveable)`` on its scan body.

Over a model axis (``tp``) every block splits as ``attention`` and
``mlp`` state; the embedding (and an untied ``lm_head``) holds this rank's
block of vocabulary rows (columns), the cross-entropy combines the ranks'
partial sums (``common.chunked_cross_entropy``), gemma2's final softcap
acts on each rank's logits, and prefill's and decode's logits are
gathered whole over the model axis. A ``seq``-policy cache holds this
rank's slots, rows j % M == r of the unsplit cache (padded to a multiple
of M: gemma2's 8-row smoke window holds one row a rank at M = 16).
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
from .mlp import init_mlp, init_moe, mlp_block, moe_block


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    """Attention kind per slot within one pattern group."""
    if cfg.local_global_period:
        # gemma2: [local, global] alternating.
        return tuple("local" if j % 2 == 0 else "global"
                     for j in range(cfg.local_global_period))
    return ("local" if cfg.window else "global",)


def _init_block(generator, cfg: ModelConfig, dtype, device) -> dict:
    b = ParamBuilder(generator, dtype, device)
    init_attention(b, cfg)
    if cfg.n_experts:
        init_moe(b, cfg)
    else:
        init_mlp(b, cfg.d_model, cfg.d_ff)
    if cfg.parametric_norm:
        norm_init = b.zeros if cfg.gemma_plus_one else b.ones
        names = ["ln1", "ln2"]
        if cfg.sandwich_norm:
            names += ["post_ln1", "post_ln2"]
        for name in names:
            norm_init(name, (cfg.d_model,))
    return b.params


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Parameters drawn from ``generator`` with the reference's scales
    (``init_lm``): dense weights normal x fan_in^-1/2 in ``dtype``, the
    embedding x d_model^-1/2, norm weights f32 (ones, or zeros for the
    (1 + w) parameterization); an MoE router f32."""
    period = max(cfg.local_global_period, 1)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers do not group by {period}")
    layers = [_init_block(generator, cfg, dtype, device)
              for _ in range(cfg.n_layers)]
    b = ParamBuilder(generator, dtype, device)
    b.dense("embed", (cfg.vocab_size, cfg.d_model), scale=cfg.d_model ** -0.5)
    if not cfg.tie_embeddings:
        b.dense("lm_head", (cfg.d_model, cfg.vocab_size))
    if cfg.parametric_norm:
        (b.zeros if cfg.gemma_plus_one else b.ones)("final_norm",
                                                    (cfg.d_model,))
    return {**b.params, "layers": layers}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _maybe_norm(p, name: str, x, cfg: ModelConfig):
    w = p.get(name) if cfg.parametric_norm else None
    return rms_norm(x, w, plus_one=cfg.gemma_plus_one)


def _ffn(pj, h, cfg: ModelConfig, tp: TP = TP1):
    return moe_block(pj, h, cfg, tp=tp) if cfg.n_experts \
        else mlp_block(pj, h, tp=tp)


def _block_fwd(pj, x, cfg: ModelConfig, kind: str, *, positions=None,
               q_chunk=512, tp: TP = TP1):
    window = cfg.window if kind == "local" else None
    h = _maybe_norm(pj, "ln1", x, cfg)
    a, kv = attention_block(pj, h, cfg, window=window, positions=positions,
                            q_chunk=q_chunk, tp=tp)
    if cfg.sandwich_norm:
        a = _maybe_norm(pj, "post_ln1", a, cfg)
    x = x + a
    h = _maybe_norm(pj, "ln2", x, cfg)
    m = _ffn(pj, h, cfg, tp)
    if cfg.sandwich_norm:
        m = _maybe_norm(pj, "post_ln2", m, cfg)
    return x + m, kv


def _block_decode(pj, x, cache_k, cache_v, pos, cfg: ModelConfig, kind: str,
                  tp: TP = TP1):
    window = cfg.window if kind == "local" else None
    h = _maybe_norm(pj, "ln1", x, cfg)
    a, _, _ = decode_attention(pj, h, cache_k, cache_v, pos, cfg,
                               window=window, tp=tp)
    if cfg.sandwich_norm:
        a = _maybe_norm(pj, "post_ln1", a, cfg)
    x = x + a
    h = _maybe_norm(pj, "ln2", x, cfg)
    m = _ffn(pj, h, cfg, tp)
    if cfg.sandwich_norm:
        m = _maybe_norm(pj, "post_ln2", m, cfg)
    return x + m


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg: ModelConfig, tp: TP = TP1):
    x = embed_lookup(params["embed"], tokens, tp)
    if cfg.gemma_plus_one:                          # gemma scales embeddings
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _group_fwd(x, layers, cfg: ModelConfig, kinds, q_chunk, tp: TP = TP1):
    """One layer group (one period): the residual stream through its
    layers; returns it and the layers' (k, v)."""
    kvs = []
    for pj, kind in zip(layers, kinds):
        x, kv = _block_fwd(pj, x, cfg, kind, q_chunk=q_chunk, tp=tp)
        kvs.append(kv)
    return x, kvs


def forward(params, tokens, cfg: ModelConfig, *, remat: bool = False,
            collect_cache: bool = False, inputs_embeds=None,
            q_chunk: int | None = None, tp: TP = TP1):
    """Full-sequence forward. Returns (hidden [B, S, D], per-layer (k, v)
    list when ``collect_cache``, else None). ``remat`` recomputes each
    layer group in the backward pass from the residual stream at its
    start (``torch.utils.checkpoint``), so nothing inside a group is
    saved; the reference defaults it on, the port off, since its serving
    path runs without gradients."""
    if remat and collect_cache:
        raise ValueError("remat recomputes the layers' K and V; it does not "
                         "collect them")
    q_chunk = q_chunk or cfg.q_chunk
    kinds = _layer_kinds(cfg)
    period = len(kinds)
    x = inputs_embeds if inputs_embeds is not None \
        else _embed(params, tokens, cfg, tp)
    caches = []
    layers = params["layers"]
    for g in range(0, len(layers), period):
        group = layers[g:g + period]
        if remat:
            x = checkpoint(lambda x, group=group: _group_fwd(
                x, group, cfg, kinds, q_chunk, tp)[0], x,
                use_reentrant=False)
        else:
            x, kvs = _group_fwd(x, group, cfg, kinds, q_chunk, tp)
            if collect_cache:
                caches += kvs
    x = _maybe_norm(params, "final_norm", x, cfg)
    return x, (caches if collect_cache else None)


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True,
            q_chunk: int | None = None, tp: TP = TP1) -> torch.Tensor:
    """Mean next-token CE of ``batch`` ({"tokens", "labels"} [B, S]; labels
    of -1 are padding) through the chunked cross-entropy; the untied
    ``lm_head`` [D, V] is used transposed, as the reference does."""
    hidden, _ = forward(params, batch["tokens"], cfg, remat=remat,
                        q_chunk=q_chunk, tp=tp)
    b, s, d = hidden.shape
    emb = params.get("lm_head")
    emb = params["embed"] if emb is None else emb.T
    return chunked_cross_entropy(
        hidden.reshape(b * s, d), emb, batch["labels"].reshape(b * s),
        logit_softcap=cfg.final_softcap, tp=tp)


def _logits_last(params, hidden_last, cfg: ModelConfig, tp: TP = TP1):
    """hidden_last: [B, D] -> [B, V] f32 (gathered whole over ``tp``)."""
    emb = params.get("lm_head")
    w = params["embed"].T if emb is None else emb
    logits = (hidden_last @ w.to(hidden_last.dtype)).to(torch.float32)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return tp.gather(logits, -1)


def _cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    return min(cfg.window, seq_len) if (kind == "local" and cfg.window) \
        else seq_len


def prefill(params, tokens, cfg: ModelConfig, *, max_len: int | None = None,
            tp: TP = TP1):
    """Run the prompt, return (cache, last-token logits [B, V] f32).

    Local (windowed) layers keep a ring buffer of the last ``window``
    positions, rolled so that position p sits in row p % window; the other
    layers are zero-padded to ``max_len`` rows. The cache is in the
    parameters' dtype (the serving engine rounds it to its cache dtype)."""
    kinds = _layer_kinds(cfg)
    period = len(kinds)
    s = tokens.shape[1]
    max_len = max_len or s
    hidden, caches = forward(params, tokens, cfg, collect_cache=True, tp=tp)
    cache = {}
    for j, kind in enumerate(kinds):
        clen = _cache_len(cfg, kind, max_len)
        ks, vs = [], []
        for k, v in caches[j::period]:               # [B, S, KH, dh]
            if clen < s:
                k = torch.roll(k[:, -clen:], s % clen, dims=1)
                v = torch.roll(v[:, -clen:], s % clen, dims=1)
            elif clen > s:
                pad = (0, 0, 0, 0, 0, clen - s)
                k, v = F.pad(k, pad), F.pad(v, pad)
            ks.append(seq_slots(k, 1, cfg, tp))
            vs.append(seq_slots(v, 1, cfg, tp))
        cache[f"k{j}"], cache[f"v{j}"] = torch.stack(ks), torch.stack(vs)
    return cache, _logits_last(params, hidden[:, -1], cfg, tp)


def seq_slots(kv: torch.Tensor, dim: int, cfg: ModelConfig, tp: TP, *,
              pad: bool = True) -> torch.Tensor:
    """This rank's slots (rows j % M == r along ``dim``) of a whole K/V
    cache under the ``seq`` policy; the cache unchanged otherwise. A cache
    of n rows that M does not divide is zero-padded to ceil(n / M) rows a
    rank, slots the decode step never reads as valid; ``pad=False``
    refuses it instead (the cross cache, whose every row is valid)."""
    if tp.size == 1 or kv_policy(cfg, tp.size) == "heads":
        return kv
    n = kv.shape[dim]
    extra = -n % tp.size
    if extra:
        if not pad:
            raise ValueError(f"a cache of {n} rows does not split over a "
                             f"model axis of {tp.size} (the seq K/V policy)")
        kv = F.pad(kv, (0, 0) * (kv.dim() - 1 - dim) + (0, extra))
    return kv.unflatten(dim, (-1, tp.size)).select(dim + 1, tp.rank) \
        .contiguous()


def decode_step(params, cache, token, pos, cfg: ModelConfig,
                tp: TP = TP1):
    """One token for the whole stack. token: [B]; pos: a scalar or a
    per-slot [B] vector. Writes the new K/V rows into ``cache`` in place.
    Returns (logits [B, V] f32, cache)."""
    kinds = _layer_kinds(cfg)
    period = len(kinds)
    x = _embed(params, token[:, None], cfg, tp)     # [B, 1, D]
    for i, pj in enumerate(params["layers"]):
        g, j = divmod(i, period)
        x = _block_decode(pj, x, cache[f"k{j}"][g], cache[f"v{j}"][g], pos,
                          cfg, kinds[j], tp)
    x = _maybe_norm(params, "final_norm", x, cfg)
    return _logits_last(params, x[:, 0], cfg, tp), cache
