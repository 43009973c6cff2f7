"""Encoder-decoder backbone: seamless-m4t-medium (the port of
``repro/models/encdec.py``).

The speech frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, S_enc, D]; the decoder is a text decoder
with self-attention (causal, RoPE), cross-attention to the encoder's output
and a SwiGLU MLP. ``params["encoder"]`` and ``params["decoder"]`` are lists
of per-layer dicts (the reference stacks them [L, ...]). The tied embedding
is padded to ``padded_vocab_size(vocab_size)`` rows; the loss and the
logits mask the padded rows. The encoder's attention goes through the flash
kernel under ``attn_impl="flash"`` (non-causal, so S_enc % 128 == 0), and
so does the decoder's self-attention over the prompt; cross-attention and
every decode path are plain PyTorch, as the reference's are plain JAX.

Over a model axis (``tp``) both stacks split as ``attention`` and ``mlp``
state, the cross-attention's ``x_`` leaves too; the tied embedding holds
this rank's block of (padded) vocabulary rows, the cross-entropy combines
the ranks' partial sums and the logits are gathered whole. The encoder
output is whole on every rank; each rank computes its own kv heads'
cross K/V from it (every kv head under ``seq``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from .attention import (attention_block, cross_attention_block,
                        decode_attention, decode_cross_attention,
                        init_attention, kv_policy)
from .common import (TP, TP1, ParamBuilder, chunked_cross_entropy,
                     embed_lookup, mask_vocab_pad, padded_vocab_size,
                     rms_norm)
from .mlp import init_mlp, mlp_block
from .transformer import seq_slots


def _init_block(generator, cfg: ModelConfig, dtype, device, *,
                decoder: bool) -> dict:
    b = ParamBuilder(generator, dtype, device)
    init_attention(b, cfg)                          # self-attention
    if decoder:
        init_attention(b, cfg, prefix="x_")         # cross-attention
    init_mlp(b, cfg.d_model, cfg.d_ff)
    for name in (("ln1", "lnx", "ln2") if decoder else ("ln1", "ln2")):
        b.ones(name, (cfg.d_model,))
    return b.params


def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Parameters drawn from ``generator`` with the reference's scales:
    dense weights normal x fan_in^-1/2 in ``dtype``, the embedding
    [padded_vocab_size(V), D] x d_model^-1/2, norm weights f32 ones."""
    enc = [_init_block(generator, cfg, dtype, device, decoder=False)
           for _ in range(cfg.n_enc_layers)]
    dec = [_init_block(generator, cfg, dtype, device, decoder=True)
           for _ in range(cfg.n_dec_layers)]
    b = ParamBuilder(generator, dtype, device)
    b.dense("embed", (padded_vocab_size(cfg.vocab_size), cfg.d_model),
            scale=cfg.d_model ** -0.5)
    b.ones("enc_final", (cfg.d_model,))
    b.ones("dec_final", (cfg.d_model,))
    return {**b.params, "encoder": enc, "decoder": dec}


def _enc_block(lp, x, cfg: ModelConfig, tp: TP = TP1):
    a, _ = attention_block(lp, rms_norm(x, lp["ln1"]), cfg, window=None,
                           causal=False, tp=tp)
    x = x + a
    return x + mlp_block(lp, rms_norm(x, lp["ln2"]), tp=tp)


def encode(params, frames, cfg: ModelConfig, *, remat: bool = True,
           tp: TP = TP1):
    """frames: [B, S_enc, D] precomputed frontend embeddings (the stub) ->
    the encoder's output [B, S_enc, D] (whole on every rank). ``remat``
    recomputes each block in the backward pass from its input (the
    reference's ``jax.checkpoint`` per scanned block)."""
    x = frames
    for lp in params["encoder"]:
        if remat:
            x = checkpoint(_enc_block, lp, x, cfg, tp, use_reentrant=False)
        else:
            x = _enc_block(lp, x, cfg, tp)
    return rms_norm(x, params["enc_final"])


def _memory_kv(lp, memory, cfg: ModelConfig, tp: TP = TP1):
    """One decoder layer's cross-attention K/V [B, S_enc, KH/M, dh] of this
    rank's kv heads (every kv head under the ``seq`` policy, whose
    ``x_wk`` / ``x_wv`` are whole) from the whole encoder output."""
    b, s, _ = memory.shape
    dh = cfg.d_head
    memory = tp.copy(memory)
    wk, wv = lp["x_wk"], lp["x_wv"]
    if tp.size > 1 and kv_policy(cfg, tp.size) == "seq":
        wk, wv = tp.copy(wk), tp.copy(wv)      # whole on every rank
    k = (memory @ wk).reshape(b, s, -1, dh)
    v = (memory @ wv).reshape(b, s, -1, dh)
    return k, v


def _dec_block(lp, x, memory, cfg: ModelConfig, tp: TP = TP1):
    a, kv = attention_block(lp, rms_norm(x, lp["ln1"]), cfg, window=None,
                            causal=True, tp=tp)
    x = x + a
    mem_kv = _memory_kv(lp, memory, cfg, tp)
    x = x + cross_attention_block(lp, rms_norm(x, lp["lnx"]), mem_kv, cfg,
                                  tp=tp)
    x = x + mlp_block(lp, rms_norm(x, lp["ln2"]), tp=tp)
    return x, kv, mem_kv


def decode_train(params, tokens, memory, cfg: ModelConfig, *,
                 remat: bool = True, collect_cache: bool = False,
                 tp: TP = TP1):
    """The decoder over whole sequences. Returns (hidden [B, S, D], the
    per-layer ((k, v), (xk, xv)) list when ``collect_cache``, else None)."""
    if remat and collect_cache:
        raise ValueError("remat recomputes the layers' K and V; it does not "
                         "collect them")
    x = embed_lookup(params["embed"], tokens, tp)
    caches = []
    for lp in params["decoder"]:
        if remat:
            x = checkpoint(lambda x, m, lp=lp: _dec_block(lp, x, m, cfg,
                                                          tp)[0],
                           x, memory, use_reentrant=False)
        else:
            x, kv, mem_kv = _dec_block(lp, x, memory, cfg, tp)
            if collect_cache:
                caches.append((kv, mem_kv))
    return rms_norm(x, params["dec_final"]), (caches if collect_cache
                                              else None)


def seq2seq_loss(params, batch, cfg: ModelConfig, *, remat: bool = True,
                 tp: TP = TP1) -> torch.Tensor:
    """Mean next-token CE of ``batch`` ({"frames" [B, S_enc, D], "tokens",
    "labels" [B, S]; labels of -1 are padding), the padded vocabulary rows
    masked out of the partition function."""
    memory = encode(params, batch["frames"], cfg, remat=remat, tp=tp)
    hidden, _ = decode_train(params, batch["tokens"], memory, cfg,
                             remat=remat, tp=tp)
    b, s, d = hidden.shape
    return chunked_cross_entropy(hidden.reshape(b * s, d), params["embed"],
                                 batch["labels"].reshape(b * s),
                                 n_valid_vocab=cfg.vocab_size, tp=tp)


def _logits(params, hidden_last, cfg: ModelConfig, tp: TP = TP1):
    """hidden_last: [B, D] -> [B, V_pad] f32 (gathered whole over ``tp``),
    the padded tail at -1e30."""
    logits = (hidden_last @ params["embed"].T.to(hidden_last.dtype)).to(
        torch.float32)
    return mask_vocab_pad(tp.gather(logits, -1), cfg.vocab_size)


def prefill(params, frames, tokens, cfg: ModelConfig, *, max_len: int,
            tp: TP = TP1):
    """Encode the frames and prime the decoder with ``tokens``. Returns
    (cache, last-token logits [B, V_pad] f32): the cache holds the
    self-attention K/V zero-padded to ``max_len`` rows ("k", "v" [L, B,
    max_len, KH, dh]) and the cross K/V ("xk", "xv" [L, B, S_enc, KH,
    dh]), in the parameters' dtype; over a model axis this rank's kv
    heads, or under ``seq`` its rows j % M == r of both."""
    memory = encode(params, frames, cfg, remat=False, tp=tp)
    hidden, caches = decode_train(params, tokens, memory, cfg, remat=False,
                                  collect_cache=True, tp=tp)
    s = tokens.shape[1]
    pad = (0, 0, 0, 0, 0, max(max_len - s, 0))

    def stack(i, j):
        return torch.stack([seq_slots(F.pad(c[i][j], pad) if i == 0
                                      else c[i][j], 1, cfg, tp, pad=i == 0)
                            for c in caches])
    cache = {"k": stack(0, 0), "v": stack(0, 1), "xk": stack(1, 0),
             "xv": stack(1, 1)}
    return cache, _logits(params, hidden[:, -1], cfg, tp)


def decode_step(params, cache, token, pos, cfg: ModelConfig, tp: TP = TP1):
    """One token for the decoder. token: [B]; pos: a scalar or a per-slot
    [B] vector. Writes the new self-attention K/V rows into ``cache`` in
    place; the cross K/V stay. Returns (logits [B, V_pad] f32, cache)."""
    x = embed_lookup(params["embed"], token[:, None], tp)   # [B, 1, D]
    for i, lp in enumerate(params["decoder"]):
        a, _, _ = decode_attention(lp, rms_norm(x, lp["ln1"]),
                                   cache["k"][i], cache["v"][i], pos, cfg,
                                   tp=tp)
        x = x + a
        x = x + decode_cross_attention(lp, rms_norm(x, lp["lnx"]),
                                       (cache["xk"][i], cache["xv"][i]), cfg,
                                       tp=tp)
        x = x + mlp_block(lp, rms_norm(x, lp["ln2"]), tp=tp)
    x = rms_norm(x, params["dec_final"])
    return _logits(params, x[:, 0], cfg, tp), cache
