"""GQA attention: the training / prefill path (the flash kernel or chunked
attention), the decode path over a per-slot KV cache, and the
encoder-decoder's cross-attention over the encoder's K/V (the port of
``repro/models/attention.py``).

Over a model axis (``tp``, Megatron-style) a rank holds H/M query heads
(its columns of wq, its rows of wo, whose product is summed over the ranks)
and its K/V follow the reference's ``_kv_policy``:

* ``heads`` (KH % M == 0): wk and wv split by kv heads like wq; each rank
  caches its KH/M kv heads, whole along the sequence;
* ``seq`` (otherwise): wk and wv stay whole on every rank. Prefill passes
  the attention only the contiguous kv heads its own q heads read
  (``local_kv_heads``), so the GQA grouping is the unsplit one. The
  decode cache is split over the sequence: rank r keeps cache rows
  (slots) j with j % M == r, in local row j // M, every kv head; a
  decode step gathers every rank's q heads, takes the softmax's partial
  (max m, sum l, output o) over its own slots, and the ranks' partials
  are combined by log-sum-exp in rank order on every rank. The cache
  length must split over M.

A model axis wider than the query heads (M % H == 0, d_head % (M / H)
== 0) splits each head mid-head: r = M / H consecutive ranks form a
head's group, and rank q holds the reference's 1/M column block of wq
(d_head / r columns of head q // r) and the matching rows of wo. K/V are
always ``seq`` then (KH <= H < M). The rank's q columns are all_gathered
over the model axis (``tp.all_gather``: its backward reduce_scatters the
ranks' partial gradients, since every rank of a group consumes the whole
head) and the group's head is sliced out before qk-norm and RoPE; every
rank of the group attends that one head against its kv head, keeps its
d_head / r output columns and multiplies them by its rows of wo, which
``tp.reduce`` sums. So a device's attention work is one head's, as the
reference's GSPMD program runs on each device. Decode under ``seq``
attends every head: the gathered q is whole, and each rank keeps its
flattened output columns. The gather over the whole axis bills an
all_gather of [B, S, H dh] a layer forward (``mesh.tally()``), r times
the group's own head.

Cross-attention (the ``x_`` leaves) splits the same way: ``x_wq`` by
columns, ``x_wo`` by rows, ``x_wk`` / ``x_wv`` by kv heads or whole; its
``seq`` cache holds memory rows j % M == r, and its decode step combines
the ranks' partials as above with every memory row valid (no causal
position mask: the memory is the whole encoder output).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .common import NEG_INF, TP, TP1, ParamBuilder, apply_rope, \
    chunked_attention, rms_norm


def kv_policy(cfg: ModelConfig, tp_size: int) -> str:
    """The reference's ``_kv_policy``: 'heads' when the kv heads split over
    the model axis, else 'seq'."""
    return "heads" if cfg.n_kv_heads % tp_size == 0 else "seq"


def local_kv_heads(cfg: ModelConfig, tp: TP) -> slice | list:
    """The kv heads (global ids) that rank ``tp.rank``'s query heads read,
    one per local GQA group: a slice when each kv head serves whole groups
    of its q heads, else one kv head per q head (under a mid-head split
    the kv head of its group's head)."""
    groups = cfg.n_heads // cfg.n_kv_heads
    r = tp.group(cfg.n_heads)
    if r > 1:                      # mid-head: the group's one head
        kv = tp.rank // r // groups
        return slice(kv, kv + 1)
    h_l = tp.local(cfg.n_heads, "query heads")
    q0 = tp.rank * h_l
    if h_l % groups == 0:
        return slice(q0 // groups, (q0 + h_l) // groups)
    if groups % h_l == 0:
        return slice(q0 // groups, q0 // groups + 1)
    return [(q0 + i) // groups for i in range(h_l)]


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


def _q_heads(q, cfg: ModelConfig, tp: TP, all_heads: bool = False):
    """The rank's query columns [B, S, H dh / M] as heads [B, S, h, dh]:
    its H/M heads, or under a mid-head split its group's whole head
    (every head with ``all_heads``), all_gathered over the model axis."""
    b, s, _ = q.shape
    r, dh = tp.group(cfg.n_heads), cfg.d_head
    if r > 1:
        q = tp.all_gather(q, -1)
        if not all_heads:
            h = tp.rank // r
            q = q[..., h * dh:(h + 1) * dh]
    return q.reshape(b, s, -1, dh)


def _own_cols(out, cfg: ModelConfig, tp: TP):
    """[..., h dh] attention output -> the columns this rank's rows of wo
    take: all of them, or under a mid-head split its d_head / r columns
    of its group's head."""
    r = tp.group(cfg.n_heads)
    if r == 1:
        return out
    w = cfg.d_head // r
    c = tp.rank % r * w
    return out[..., c:c + w]


def _project_qkv(p, x, cfg: ModelConfig, positions, prefix="", tp=TP1,
                 all_heads: bool = False):
    """q [B, S, H/M, dh] (mid-head: [B, S, 1, dh], the group's head, or
    every head with ``all_heads``); k, v [B, S, KH/M, dh] (``heads``) or
    [B, S, KH, dh] (``seq``, and at one rank)."""
    b, s, _ = x.shape
    dh = cfg.d_head
    x = tp.copy(x)
    wk, wv = p[prefix + "wk"], p[prefix + "wv"]
    if tp.size > 1 and kv_policy(cfg, tp.size) == "seq":
        wk, wv = tp.copy(wk), tp.copy(wv)      # whole on every rank
    q = _q_heads(x @ p[prefix + "wq"], cfg, tp, all_heads)
    k = (x @ wk).reshape(b, s, -1, dh)
    v = (x @ wv).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = rms_norm(q, tp.copy(p[prefix + "qn"]))
        k = rms_norm(k, tp.copy(p[prefix + "kn"]))
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def attention_block(p, x, cfg: ModelConfig, *, window: int | None,
                    causal: bool = True, positions=None, prefix: str = "",
                    q_chunk: int = 512, tp: TP = TP1):
    """Full-sequence attention (training / prefill). Returns (out, (k, v)),
    k and v as ``_project_qkv`` makes them (this rank's cache material).

    ``attn_impl="flash"`` on a layer without a window goes through
    ``ops.flash_attention`` — the CUDA kernel for a tensor on the card, its
    plain version on the CPU; it is forward only and raises when a
    gradient would flow through it. Every other layer takes chunked
    attention."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, prefix, tp)
    kq, vq = k, v
    if tp.size > 1 and kv_policy(cfg, tp.size) == "seq":
        idx = local_kv_heads(cfg, tp)
        kq, vq = k[:, :, idx].contiguous(), v[:, :, idx].contiguous()
    if cfg.attn_impl == "flash" and window is None:
        # [B, S, H, dh] -> [B, H, S, dh] views and back: the kernel reads
        # and writes them in place
        out = ops.flash_attention(
            q.transpose(1, 2), kq.transpose(1, 2), vq.transpose(1, 2),
            causal=causal, softcap=cfg.attn_softcap).transpose(1, 2)
    else:
        out = chunked_attention(q, kq, vq, causal=causal, window=window,
                                attn_softcap=cfg.attn_softcap,
                                q_chunk=q_chunk)
    out = _own_cols(out.reshape(b, s, q.shape[2] * cfg.d_head), cfg, tp)
    return tp.reduce(out @ p[prefix + "wo"]), (k, v)


def cross_attention_block(p, x, memory_kv, cfg: ModelConfig, *,
                          prefix: str = "x_", tp: TP = TP1):
    """Decoder cross-attention against precomputed encoder (k, v) [B, Sm,
    KH, dh] (this rank's kv heads, or every kv head under ``seq``):
    chunked attention, not causal, no RoPE on q (the reference sends it
    through no kernel). Over a model axis a rank attends with its H/M
    query heads (mid-head: its group's head) and its rows of ``x_wo`` are
    summed over the ranks."""
    b, s, _ = x.shape
    dh = cfg.d_head
    q = _q_heads(tp.copy(x) @ p[prefix + "wq"], cfg, tp)
    k, v = memory_kv
    if tp.size > 1 and kv_policy(cfg, tp.size) == "seq":
        idx = local_kv_heads(cfg, tp)
        k, v = k[:, :, idx].contiguous(), v[:, :, idx].contiguous()
    out = chunked_attention(q, k, v, causal=False, window=None,
                            attn_softcap=cfg.attn_softcap)
    out = _own_cols(out.reshape(b, s, q.shape[2] * dh), cfg, tp)
    return tp.reduce(out @ p[prefix + "wo"])


def decode_attention(p, x, cache_k, cache_v, pos, cfg: ModelConfig, *,
                     window: int | None = None, prefix: str = "",
                     tp: TP = TP1):
    """One-token decode: write the new K/V at ``pos``, attend over the cache.

    x: [B, 1, D]; cache_k/v: [B, S, KH, dh] (a ring buffer when ``window``).
    ``pos`` is a scalar or a per-slot [B] vector (continuous batching: each
    slot sits at its own cursor). The reference returns new cache arrays;
    the port writes the new rows into ``cache_k``/``cache_v`` in place
    (rounded to the cache's dtype), so the serving engine keeps one cache
    allocation. Over a model axis the cache holds this rank's kv heads
    (``heads``) or its slots (``seq``, ``_decode_seq``). Returns (out [B,
    1, D], cache_k, cache_v)."""
    b = x.shape[0]
    dh = cfg.d_head
    s = cache_k.shape[1]
    pos_b = torch.as_tensor(pos, dtype=torch.long,
                            device=x.device).expand(b)            # [B]
    # a mid-head split gathers every head: the seq policy attends them all
    q, k, v = _project_qkv(p, x, cfg, pos_b[:, None], prefix, tp,
                           all_heads=True)
    if tp.size > 1 and kv_policy(cfg, tp.size) == "seq":
        return _decode_seq(p, q, k, v, cache_k, cache_v, pos_b, cfg,
                           window=window, prefix=prefix, tp=tp)
    h, kh = q.shape[2], k.shape[2]

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
    return tp.reduce(out @ p[prefix + "wo"]), cache_k, cache_v


def _decode_seq(p, q, k, v, cache_k, cache_v, pos_b, cfg: ModelConfig, *,
                window, prefix, tp: TP):
    """Decode under the ``seq`` policy: the cache [B, ceil(n / M), KH, dh]
    holds slots r, r + M, ... of n, the slots past n (a pad when M does
    not divide n) never valid; q [B, 1, H/M, dh] (mid-head: every head),
    k and v [B, 1, KH, dh]. A ring wraps at n: the window, or the cache
    length when that is shorter (its positions never reach the window,
    so any ring of at least the cache length reads alike)."""
    b = q.shape[0]
    s_l = cache_k.shape[1]
    s = s_l * tp.size                          # the slots, the pad included
    if window is not None:
        s = min(window, s)
    slot_b = pos_b % s if window is not None else pos_b
    own = (slot_b % tp.size) == tp.rank
    row = torch.clamp(slot_b // tp.size, max=s_l - 1)
    rows = torch.arange(b, device=q.device)
    for cache, new in ((cache_k, k), (cache_v, v)):
        cur = cache[rows, row]
        cache[rows, row] = torch.where(own[:, None, None],
                                       new[:, 0].to(cache.dtype), cur)
    kpos = torch.arange(s_l, device=q.device) * tp.size + tp.rank
    valid = kpos[None, :] <= pos_b[:, None]
    if window is not None:
        valid = valid | (pos_b[:, None] >= s)
    valid = valid & (kpos < s)[None, :]
    out = _seq_attend(q, cache_k, cache_v, valid, cfg, tp,
                      softcap=cfg.attn_softcap)
    return tp.reduce(out @ p[prefix + "wo"]), cache_k, cache_v


def _seq_attend(q, cache_k, cache_v, valid, cfg: ModelConfig, tp: TP, *,
                softcap=None):
    """One query token against K/V rows split over the model axis (rank r
    holds rows r, r + M, ...; ``valid`` [B, S/M] masks its rows): every
    rank's q heads are gathered (a mid-head split passes them whole),
    each rank takes the softmax's partial (max m, sum l, output o) over
    its own rows for every head, and the ranks' partials are combined by
    log-sum-exp in rank order on every rank. q: [B, 1, H/M, dh] -> this
    rank's block of the flattened output columns [B, 1, H dh / M]."""
    b, _, h_q, dh = q.shape
    kh, groups = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q_all = q if h_q == cfg.n_heads else tp.gather(q, 2)
    q_all = q_all.reshape(b, kh, groups, dh).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", q_all,
                          cache_k.to(torch.float32)) * dh ** -0.5
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = torch.max(scores, dim=-1).values                          # [B,KH,G]
    e = torch.where(valid, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    o = torch.einsum("bkgs,bskd->bkgd", e, cache_v.to(torch.float32))
    part = torch.cat([o, e.sum(dim=-1)[..., None], m[..., None]], dim=-1)
    parts = tp.gather(part[None], 0)                  # [M, B, KH, G, dh+2]
    o_r, l_r, m_r = parts[..., :dh], parts[..., dh], parts[..., dh + 1]
    w = torch.exp(m_r - torch.max(m_r, dim=0).values)
    out = (w[..., None] * o_r).sum(dim=0) / (w * l_r).sum(dim=0)[..., None]
    cols = kh * groups * dh // tp.size
    out = out.reshape(b, kh * groups * dh)[:, tp.rank * cols:(tp.rank + 1)
                                           * cols]
    return out.reshape(b, 1, cols).to(q.dtype)


def decode_cross_attention(p, x, memory_kv, cfg: ModelConfig, *,
                           prefix: str = "x_", tp: TP = TP1):
    """One decoder token against the encoder's (k, v) [B, Sm, KH, dh]:
    scores and softmax in f32, every memory row valid. x: [B, 1, D] ->
    [B, 1, D]. Over a model axis the cache holds this rank's kv heads
    (``heads``) or its memory rows j % M == r with every kv head
    (``seq``: ``_seq_attend`` with every row valid, no causal mask)."""
    b = x.shape[0]
    dh = cfg.d_head
    k, v = memory_kv
    q = _q_heads(tp.copy(x) @ p[prefix + "wq"], cfg, tp, all_heads=True)
    if tp.size > 1 and kv_policy(cfg, tp.size) == "seq":
        valid = torch.ones((b, k.shape[1]), dtype=torch.bool,
                           device=x.device)
        out = _seq_attend(q, k, v, valid, cfg, tp)
        return tp.reduce(out @ p[prefix + "wo"])
    h, kh = q.shape[2], k.shape[2]
    qg = q.reshape(b, kh, h // kh, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k.to(torch.float32)) * dh ** -0.5
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.to(torch.float32))
    return tp.reduce(out.reshape(b, 1, h * dh).to(x.dtype)
                     @ p[prefix + "wo"])
