"""RWKV6 "Finch" (attention-free, data-dependent decay): rwkv6-7b (the port
of ``repro/models/rwkv.py``).

Recurrence per head (K = V = 64 channels a head):

    out_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(-exp(wx_t))

Training and prefill use a GLA-style chunked form: a loop over chunks of 64
carries the [B, H, K, V] state in f32; the intra-chunk quadratic path works
in log-decay space with the per-chunk cumulative decay clipped to [-30, 0]
(decay products below e^-30 are 0 in f32 regardless; without the clip
exp(-cum) overflows). The scan is plain PyTorch, as the reference's is
plain JAX (no kernel); the family attends nothing, so no flash launch.

The reference's simplification of the released checkpoints stays: the
token-shift interpolation uses static per-channel mu for r/k/v/g/w; the
decay keeps the data-dependent LoRA (the Finch mechanism). Channel-mix is
the r-gated squared ReLU. ``params["layers"]`` is a list of per-layer
dicts (the reference stacks them [L, ...]); the cache is "tm_x" [L, B, D],
"wkv" [L, B, H, 64, 64] (f32) and "cm_x" [L, B, D].

Over a model axis (``tp``) the 64-channel heads split (``time_mix``,
``channel_mix``), the embedding holds this rank's block of vocabulary
rows and the logits are gathered whole. The wkv state holds this rank's
H/M heads. The token-shift rows "tm_x" and "cm_x" stay whole on every
rank: they are the layer's whole input row, which every rank needs before
its column-split products (the reference's spec splits them by ``model``;
keeping them whole costs L x B x D a leaf per rank, 2 MB at rwkv6-7b
with 8 slots in bf16, and no gather a tick).

A model axis wider than the heads (M % H == 0, 64 % (M / H) == 0) splits
each head over r = M / H ranks, the leaves cut as above (the rank's 1/M
blocks: 64 / r channels of head q // r). The wkv contraction runs over
the key channels, so r, k, the decay and u are made whole for the
group's head on every rank of the group (one all_gather of r | k | decay
and one of u a layer, ``tp.all_gather``); v and g stay split by value
channels, and the state [B, 1, 64, 64 / r] splits the head's along them.
The per-head norm sums the group's partial sums of squares (one
all_gather of [B, S, 1] a layer).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from .common import (TP, TP1, ParamBuilder, chunked_cross_entropy,
                     embed_lookup, rms_norm)

_K_HEAD = 64
_LORA = 64
_MU = 0.5     # the token-shift interpolation's initial weight


def rwkv_dims(cfg: ModelConfig) -> int:
    """The wkv heads (64 channels each)."""
    return cfg.d_model // _K_HEAD


def _full(b: ParamBuilder, name: str, shape, value: float):
    """An f32 leaf of ``value`` whatever the builder's dtype."""
    b.params[name] = torch.full(shape, value, dtype=torch.float32,
                                device=b.device)


def init_time_mix(b: ParamBuilder, cfg: ModelConfig):
    d = cfg.d_model
    for name in ("wr", "wk", "wv", "wg", "wo"):
        b.dense(name, (d, d))
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        _full(b, name, (d,), _MU)
    b.zeros("w0", (d,))
    b.dense("w1", (d, _LORA), scale=0.1)
    b.dense("w2", (_LORA, d), scale=0.1)
    b.zeros("u", (d,))              # bonus, per channel
    b.ones("ln_x", (d,))            # per-head group norm weight


def init_channel_mix(b: ParamBuilder, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    _full(b, "cmu_k", (d,), _MU)
    _full(b, "cmu_r", (d,), _MU)
    b.dense("ck", (d, f))
    b.dense("cv", (f, d))
    b.dense("cr", (d, d))


def _token_shift(x, x_last=None):
    """[B, S, D] -> the previous token's features (zeros at t = 0, or
    ``x_last`` [B, D] carried from the previous call)."""
    first = torch.zeros_like(x[:, :1]) if x_last is None \
        else x_last[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _wkv_chunk(state, rr, kk, vv, ww, uh, tri_strict):
    """One chunk, f32. state [B, H, K, V]; rr/kk/vv/ww [B, H, q, K]; uh
    [H, K]. Returns (new state, out [B, H, q, V])."""
    cum = torch.clamp(torch.cumsum(ww, dim=2), -30.0, 0.0)    # [B, H, q, K]
    # intra: out_t = sum_{i<t} (r_t . exp(cum_{t-1} - cum_i) k_i) v_i
    cum_prev = F.pad(cum, (0, 0, 1, 0))[:, :, :-1]
    a = rr * torch.exp(cum_prev)
    bmat = kk * torch.exp(-cum)
    scores = torch.einsum("bhtk,bhik->bhti", a, bmat)
    scores = torch.where(tri_strict, scores, torch.zeros_like(scores))
    out = torch.einsum("bhti,bhiv->bhtv", scores, vv)
    # diagonal bonus: (r_t . u k_t) v_t
    out = out + torch.sum(rr * kk * uh[None, :, None, :], dim=-1)[..., None] \
        * vv
    # inter: out_t += (r_t . exp(cum_{t-1})) @ state
    out = out + torch.einsum("bhtk,bhkv->bhtv", a, state)
    # state: S <- diag(exp(cum_Q)) S + sum_i exp(cum_Q - cum_i) k_i v_i
    wq = cum[:, :, -1:, :]
    kdec = kk * torch.exp(torch.clamp(wq - cum, -30.0, 0.0))
    state = state * torch.exp(wq[:, :, 0, :])[..., None] \
        + torch.einsum("bhik,bhiv->bhkv", kdec, vv)
    return state, out


def _wkv_chunked(r, k, v, logw, u, n_heads: int, *, chunk: int = 64,
                 initial_state=None):
    """r/k/logw: [B, S, H K]; v: [B, S, H V] (V = K, or a mid-head
    split's value channels); u: [H K]. Returns (out [B, S, H V] f32, final
    state [B, H, K, V] f32)."""
    bsz, s, _ = r.shape
    dv = v.shape[-1] // n_heads
    q = min(chunk, s)
    pad = -(-s // q) * q - s

    def heads(t):   # [B, S, H C] -> [B, H, S_pad, C] f32
        t = F.pad(t, (0, 0, 0, pad)).to(torch.float32)
        return t.reshape(bsz, s + pad, n_heads, -1).transpose(1, 2)

    rh, kh, vh, wh = heads(r), heads(k), heads(v), heads(logw)
    uh = u.to(torch.float32).reshape(n_heads, _K_HEAD)
    tri_strict = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                       device=r.device), diagonal=-1)
    state = initial_state if initial_state is not None else torch.zeros(
        (bsz, n_heads, _K_HEAD, dv), dtype=torch.float32, device=r.device)
    outs = []
    for c0 in range(0, s + pad, q):
        sl = slice(c0, c0 + q)
        state, out = _wkv_chunk(state, rh[:, :, sl], kh[:, :, sl],
                                vh[:, :, sl], wh[:, :, sl], uh, tri_strict)
        outs.append(out)
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(
        bsz, s + pad, n_heads * dv)
    return out[:, :s], state


def time_mix(p, x, cfg: ModelConfig, *, state=None, chunk: int = 64,
             tp: TP = TP1):
    """RWKV6's attention analogue. ``state`` = (x_last [B, D], wkv [B, H/M,
    K, V] f32) or None (from zeros). Returns (out [B, S, D], (x[:, -1],
    the final wkv state)).

    Over a model axis of M ranks a rank holds H/M heads: its columns of
    wr, wk, wv, wg and w2 (the decay LoRA's up-projection, so the decay
    is computed for its own channels only), its rows of wo, and its
    heads' slices of u, w0 and ln_x; the mu_* weights and w1 stay whole.
    Every input of a column-split product enters through ``tp.copy`` and
    the output projection's partial sums leave through ``tp.reduce``.
    Mid-head (the module docstring) a rank holds one head's value
    channels, the wkv state [B, 1, K, V / r]."""
    rg = tp.group(rwkv_dims(cfg))
    n_heads = tp.local(rwkv_dims(cfg), "RWKV6 heads") if rg == 1 else 1
    bsz, s, _ = x.shape
    x_last, wkv0 = state if state is not None else (None, None)
    prev = _token_shift(x, x_last)

    def lerp(mu):
        return x + (prev - x) * mu[None, None, :].to(x.dtype)

    r = tp.copy(lerp(p["mu_r"])) @ p["wr"]
    k = tp.copy(lerp(p["mu_k"])) @ p["wk"]
    v = tp.copy(lerp(p["mu_v"])) @ p["wv"]
    g = tp.copy(lerp(p["mu_g"])) @ p["wg"]
    # the data-dependent decay (the Finch mechanism), in f32
    xw = lerp(p["mu_w"]).to(torch.float32)
    lora = tp.copy(torch.tanh(xw @ p["w1"].to(torch.float32)))
    wx = p["w0"] + lora @ p["w2"].to(torch.float32)
    logw = -torch.exp(wx)                                # [B, S, D/M] < 0
    u = p["u"]
    if rg > 1:        # the group's head whole: r, k, the decay and u
        h = tp.rank // rg
        rkw = tp.all_gather(torch.cat([r.to(torch.float32),
                                       k.to(torch.float32), logw], -1), -1)
        r, k, logw = rkw.unflatten(-1, (tp.size, 3, -1))[
            ..., h * rg:(h + 1) * rg, :, :].transpose(-3, -2).flatten(
            -2).unbind(-2)
        u = tp.all_gather(u, 0)[h * _K_HEAD:(h + 1) * _K_HEAD]
    out, wkv = _wkv_chunked(r, k, v, logw, u, n_heads, chunk=chunk,
                            initial_state=wkv0)
    # per-head group norm (RMS over each head's channels) and the ln_x gain
    d_l = out.shape[-1]
    if rg > 1:        # the group's partial sums of squares
        ss = tp.all_gather(torch.sum(out * out, dim=-1, keepdim=True), -1)
        ss = ss[..., h * rg:(h + 1) * rg].sum(dim=-1, keepdim=True)
        out = out * torch.rsqrt(ss / _K_HEAD + 1e-6)
    else:
        out = rms_norm(out.reshape(bsz, s, n_heads, _K_HEAD), None)
    out = out.reshape(bsz, s, d_l) * p["ln_x"][None, None, :].to(out.dtype)
    out = out.to(x.dtype) * F.silu(g.to(torch.float32)).to(x.dtype)
    return tp.reduce(out @ p["wo"]), (x[:, -1], wkv)


def channel_mix(p, x, cfg: ModelConfig, *, x_last=None, tp: TP = TP1):
    """The r-gated squared-ReLU FFN. Returns (out [B, S, D], x[:, -1]).

    Over a model axis ck and cr split by columns and cv by rows (the
    reference's specs). The gate r [B, S, D/M] multiplies the whole of
    v = k @ cv, whose rank products are partial sums: the partials are
    reduce-scattered to the rank's D/M columns, gated, and the gated
    blocks all-gathered. That moves the bytes of one all_reduce of
    [B, S, D] and keeps cr cut as the reference's spec has it (an
    all_reduce of v would need cr whole, or an all_gather of r besides)."""
    prev = _token_shift(x, x_last)

    def lerp(mu):
        return x + (prev - x) * mu[None, None, :].to(x.dtype)

    k = torch.relu((tp.copy(lerp(p["cmu_k"])) @ p["ck"]).to(torch.float32)) \
        ** 2
    v = tp.scatter(k.to(x.dtype) @ p["cv"], -1)
    r = torch.sigmoid((tp.copy(lerp(p["cmu_r"])) @ p["cr"]).to(
        torch.float32))
    return tp.gather(r.to(x.dtype) * v, -1), x[:, -1]


# ---------------------------------------------------------------------------
# the RWKV6 LM
# ---------------------------------------------------------------------------


def init_rwkv_lm(cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Parameters drawn from ``generator`` with the reference's scales:
    dense weights normal x fan_in^-1/2 in ``dtype`` (the decay LoRA x 0.1),
    the embedding x d_model^-1/2; the mu_*/cmu_* interpolation weights,
    w0, u and the norm weights f32."""
    layers = []
    for _ in range(cfg.n_layers):
        b = ParamBuilder(generator, dtype, device)
        init_time_mix(b, cfg)
        init_channel_mix(b, cfg)
        b.ones("ln1", (cfg.d_model,))
        b.ones("ln2", (cfg.d_model,))
        layers.append(b.params)
    b = ParamBuilder(generator, dtype, device)
    b.dense("embed", (cfg.vocab_size, cfg.d_model), scale=cfg.d_model ** -0.5)
    b.ones("ln_in", (cfg.d_model,))
    b.ones("final_norm", (cfg.d_model,))
    return {**b.params, "layers": layers}


def _layer(lp, x, cfg: ModelConfig, chunk: int, tp: TP = TP1):
    h, tm_state = time_mix(lp, rms_norm(x, lp["ln1"]), cfg, chunk=chunk,
                           tp=tp)
    x = x + h
    h, cm_last = channel_mix(lp, rms_norm(x, lp["ln2"]), cfg, tp=tp)
    return x + h, (tm_state, cm_last)


def forward(params, tokens, cfg: ModelConfig, *, remat: bool = True,
            collect_state: bool = False, chunk: int = 64, tp: TP = TP1):
    """Full-sequence forward. Returns (hidden [B, S, D], per layer
    ((x_last, wkv), cm_last) when ``collect_state``, else None). ``remat``
    recomputes each layer in the backward pass from its input."""
    if remat and collect_state:
        raise ValueError("remat recomputes the layers' states; it does not "
                         "collect them")
    x = rms_norm(embed_lookup(params["embed"], tokens, tp), params["ln_in"])
    states = []
    for lp in params["layers"]:
        if remat:
            x = checkpoint(lambda x, lp=lp: _layer(lp, x, cfg, chunk, tp)[0],
                           x, use_reentrant=False)
        else:
            x, st = _layer(lp, x, cfg, chunk, tp)
            states.append(st)
    x = rms_norm(x, params["final_norm"])
    return x, (states if collect_state else None)


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True,
            tp: TP = TP1) -> torch.Tensor:
    """Mean next-token CE of ``batch`` ({"tokens", "labels"} [B, S]; labels
    of -1 are padding) against the embedding (the reference's: it adds no
    head), its vocabulary rows split over ``tp``."""
    hidden, _ = forward(params, batch["tokens"], cfg, remat=remat, tp=tp)
    b, s, d = hidden.shape
    return chunked_cross_entropy(hidden.reshape(b * s, d), params["embed"],
                                 batch["labels"].reshape(b * s), tp=tp)


def _logits(params, hidden_last, tp: TP = TP1):
    return tp.gather((hidden_last @ params["embed"].T.to(
        hidden_last.dtype)).to(torch.float32), -1)


def prefill(params, tokens, cfg: ModelConfig, *, chunk: int = 64,
            tp: TP = TP1):
    """Run the prompt, return (cache, last-token logits [B, V] f32); the
    cache holds each layer's recurrent state, whatever the prompt's
    length (over a model axis the wkv state of this rank's heads; the
    token-shift rows whole)."""
    hidden, states = forward(params, tokens, cfg, remat=False,
                             collect_state=True, chunk=chunk, tp=tp)
    cache = {"tm_x": torch.stack([tm[0] for tm, _ in states]),
             "wkv": torch.stack([tm[1] for tm, _ in states]),
             "cm_x": torch.stack([cm for _, cm in states])}
    return cache, _logits(params, hidden[:, -1], tp)


def decode_step(params, cache, token, pos, cfg: ModelConfig, tp: TP = TP1):
    """One token for the whole stack (``pos`` is unused: the state carries
    the position). Writes every layer's new state into ``cache`` in place,
    each in its leaf's dtype. Returns (logits [B, V] f32, cache)."""
    x = rms_norm(embed_lookup(params["embed"], token[:, None], tp),
                 params["ln_in"])
    for i, lp in enumerate(params["layers"]):
        tm_x, wkv, cm_x = cache["tm_x"][i], cache["wkv"][i], cache["cm_x"][i]
        h, (tm_new, wkv_new) = time_mix(lp, rms_norm(x, lp["ln1"]), cfg,
                                        state=(tm_x, wkv), tp=tp)
        x = x + h
        h, cm_new = channel_mix(lp, rms_norm(x, lp["ln2"]), cfg, x_last=cm_x,
                                tp=tp)
        x = x + h
        tm_x.copy_(tm_new)
        wkv.copy_(wkv_new)
        cm_x.copy_(cm_new)
    x = rms_norm(x, params["final_norm"])
    return _logits(params, x[:, 0], tp), cache
