"""Mamba2 (SSD) block, the state-space component of the hybrid family
(zamba2; the port of ``repro/models/ssm.py``).

Training and prefill use the chunked state-space-dual form: a loop over
chunks carries the [B, H, N, P] state in f32; each step computes the
intra-chunk quadratic path and the inter-chunk state contribution for its
chunk only, so the peak transient is one chunk's [B, Q, Q, H] decay tensor.
All decay algebra is in log space; exponents are <= 0 by construction
(A < 0, dt > 0).

    h_t = exp(dt_t A) h_{t-1} + dt_t * b_t x_t^T        (per head)
    y_t = c_t^T h_t + D * x_t

The scan is plain PyTorch, as the reference's is plain JAX (no kernel).

Over a model axis of M ranks (``tp``) the heads split: a rank holds H/M
heads, and its leaves are cut by ``convert.shard_lm`` in this layout:

* in_proj [D, z_l | x_l | B | C | dt_l]: its heads' z and x channels
  (H/M x 64 each) and dt columns, and the B and C columns whole;
* conv_w [k, x_l | B | C] and conv_b [x_l | B | C]: its x channels and
  the B and C channels whole;
* ssm_norm [x_l] and out_proj's rows [x_l, D]: its channels;
* dt_bias, A_log and D whole (the rank reads its heads' entries).

The scan runs on the rank's heads only, the gated norm's sum of squares
is all-reduced over the model axis (``common.rms_norm_split``), and the
out_proj products are summed over the ranks. The B and C columns and the
whole per-head leaves enter through ``tp.copy``, so their gradients sum
every rank's heads. The decode state is [B, H/M, N, 64] and the conv
window holds the rank's x channels and the B and C channels.

A model axis wider than the heads (M % H == 0, 64 % (M / H) == 0) splits
each head mid-head over r = M / H ranks: the rank holds 64 / r of its
head's x and z channels (the same contiguous 1/M column blocks), and its
state [B, 1, N, 64 / r] splits the head's state along its channels, on
which the recurrence acts channel by channel (its contraction runs over
N, whose B and C are whole): no collective beyond the whole-head split's.
The dt columns of in_proj are whole on every rank then, like B and C
(``convert._mamba_parts``), and the rank reads its head's dt, dt_bias,
A_log and D through ``tp.copy``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .common import TP, TP1, ParamBuilder, rms_norm, rms_norm_split

_P_HEAD = 64   # mamba2 head dim


def ssm_dims(cfg: ModelConfig):
    """(d_inner, n_heads, conv_dim) of a config's Mamba2 layers."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // _P_HEAD
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def init_mamba2(b: ParamBuilder, cfg: ModelConfig, prefix: str = ""):
    """in_proj [D, z | x | B | C | dt], the depthwise conv [k, C] (scale
    0.5) and its bias, dt_bias, A_log (f32 whatever the dtype: A = -exp(
    A_log) spans [-16, -1] over the heads), D, the gated norm and
    out_proj."""
    d = cfg.d_model
    d_inner, n_heads, conv_dim = ssm_dims(cfg)
    proj_out = 2 * d_inner + 2 * cfg.ssm_state + n_heads
    b.dense(prefix + "in_proj", (d, proj_out))
    b.dense(prefix + "conv_w", (cfg.conv_kernel, conv_dim), scale=0.5)
    b.zeros(prefix + "conv_b", (conv_dim,))
    b.zeros(prefix + "dt_bias", (n_heads,))
    b.params[prefix + "A_log"] = torch.log(torch.linspace(
        1.0, 16.0, n_heads, dtype=torch.float32, device=b.device))
    b.ones(prefix + "D", (n_heads,))
    b.ones(prefix + "ssm_norm", (d_inner,))
    b.dense(prefix + "out_proj", (d_inner, d))


def _local_dims(cfg: ModelConfig, tp: TP):
    """(x channels, heads, channels a head) of this rank: (d_inner / M,
    H / M, 64) over whole heads, (64 / r, 1, 64 / r) when r = M / H ranks
    split each head."""
    d_inner, n_heads, _ = ssm_dims(cfg)
    r = tp.group(n_heads)
    return d_inner // tp.size, max(n_heads // tp.size, 1), _P_HEAD // r


def _split_proj(proj, cfg: ModelConfig, tp: TP = TP1):
    """in_proj's output -> (z, x, B, C, dt) along the last dim (this
    rank's heads' z, x and dt; mid-head, its head's dt out of every
    head's)."""
    n_heads, n = ssm_dims(cfg)[1], cfg.ssm_state
    d_l, h_l, _ = _local_dims(cfg, tp)
    r = tp.group(n_heads)
    if r == 1:
        return torch.split(proj, [d_l, d_l, n, n, h_l], dim=-1)
    z, x, bmat, cmat, dt = torch.split(proj, [d_l, d_l, n, n, n_heads],
                                       dim=-1)
    h = tp.rank // r
    return z, x, bmat, cmat, dt[..., h:h + 1]


def _whole_cols(w, start: int, stop: int, tp: TP):
    """w with its last-dim columns [start, stop) whole on every rank: they
    enter through ``tp.copy`` so their gradient sums the ranks'."""
    if tp.size == 1:
        return w
    return torch.cat([w[..., :start], tp.copy(w[..., start:stop]),
                      w[..., stop:]], dim=-1)


def _local_params(p, cfg: ModelConfig, prefix: str, tp: TP):
    """(in_proj, conv_w, conv_b, dt_bias, A_log, D) as this rank reads
    them: the B and C columns (mid-head: and the dt columns) through
    ``tp.copy``, the per-head leaves at its heads."""
    d_inner, n_heads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    d_l = d_inner // tp.size
    r = tp.group(n_heads)
    if r == 1:
        h_l = tp.local(n_heads, "Mamba2 heads")
        heads = slice(tp.rank * h_l, (tp.rank + 1) * h_l)
        whole = 2 * d_l + 2 * n
    else:
        heads = slice(tp.rank // r, tp.rank // r + 1)
        whole = 2 * d_l + 2 * n + n_heads
    return (_whole_cols(p[prefix + "in_proj"], 2 * d_l, whole, tp),
            _whole_cols(p[prefix + "conv_w"], d_l, d_l + 2 * n, tp),
            _whole_cols(p[prefix + "conv_b"], d_l, d_l + 2 * n, tp),
            *(tp.copy(p[prefix + name])[heads]
              for name in ("dt_bias", "A_log", "D")))


def _causal_conv(xbc, conv_w, conv_b, kernel: int):
    """Depthwise causal conv over [B, S, C]; the bias and the silu in
    f32, the result in the input's dtype."""
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, kernel - 1, 0))
    out = sum(pad[:, i:i + s, :] * conv_w[i][None, None, :]
              for i in range(kernel))
    return F.silu((out + conv_b).to(torch.float32)).to(xbc.dtype)


def _ssd_chunk(state, xc, bc, cc, dtc, lc, tri):
    """One chunk of the SSD scan, all f32. state: [B, H, N, P]; xc [B, q,
    H, P], bc/cc [B, q, N], dtc/lc [B, q, H]. Returns (new state, y [B, q,
    H, P])."""
    cum = torch.cumsum(lc, dim=1)                            # [B, q, H]
    # intra: y[t] = sum_{i<=t} (c_t.b_i) exp(cum_t - cum_i) dt_i x_i
    dots = torch.einsum("bts,bis->bti", cc, bc)              # [B, q, q]
    # mask the EXPONENT, not the exponential: for i > t the difference is
    # positive and exp overflows to +inf; a mask after it would leak
    # 0 * inf = NaN into the backward pass
    diff = cum[:, :, None, :] - cum[:, None, :, :]           # [B, q, q, H]
    ddec = torch.exp(torch.where(tri[None, :, :, None], diff,
                                 torch.full_like(diff, float("-inf"))))
    g = ddec * dots[..., None] * dtc[:, None, :, :]
    y = torch.einsum("btih,bihp->bthp", g, xc)
    # inter: y[t] += exp(cum_t) c_t . state
    y = y + torch.einsum("bth,bts,bhsp->bthp", torch.exp(cum), cc, state)
    # state: S <- exp(cum_Q) S + sum_i exp(cum_Q - cum_i) dt_i b_i x_i
    tail = torch.exp(cum[:, -1:, :] - cum) * dtc             # [B, q, H]
    state = state * torch.exp(cum[:, -1, :])[:, :, None, None] \
        + torch.einsum("bih,bis,bihp->bhsp", tail, bc, xc)
    return state, y


def mamba2_block(p, x, cfg: ModelConfig, *, chunk: int = 128,
                 prefix: str = "", initial_state=None,
                 return_state: bool = False, tp: TP = TP1):
    """x: [B, S, D] -> [B, S, D]. ``initial_state`` [B, H, N, P] f32 starts
    the scan; ``return_state`` also returns (ssm [B, H, N, P] f32, conv
    [B, k - 1, C]: the last k - 1 PRE-conv rows, zeros before the first
    token)."""
    bsz, s, _ = x.shape
    d_inner = ssm_dims(cfg)[0]
    d_l, n_heads, p_head = _local_dims(cfg, tp)
    n = cfg.ssm_state
    k = cfg.conv_kernel
    in_proj, conv_w, conv_b, dt_bias, a_log, d_skip = _local_params(
        p, cfg, prefix, tp)

    z, xs, bmat, cmat, dt = _split_proj(tp.copy(x) @ in_proj, cfg, tp)
    xbc_raw = torch.cat([xs, bmat, cmat], dim=-1)      # pre-conv (state)
    xbc = _causal_conv(xbc_raw, conv_w, conv_b, k)
    xs, bmat, cmat = torch.split(xbc, [d_l, n, n], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + dt_bias)               # [B,S,H]
    a = -torch.exp(a_log)                                          # [H]
    ldec = dt * a[None, None, :]                       # [B, S, H] (<= 0)

    q = min(chunk, s)
    pad = -(-s // q) * q - s
    seq_pad = (0, 0, 0, pad)
    xs_h = F.pad(xs, seq_pad).reshape(bsz, -1, n_heads, p_head).to(
        torch.float32)
    bf = F.pad(bmat, seq_pad).to(torch.float32)
    cf = F.pad(cmat, seq_pad).to(torch.float32)
    dtp, ldp = F.pad(dt, seq_pad), F.pad(ldec, seq_pad)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = initial_state if initial_state is not None else torch.zeros(
        (bsz, n_heads, n, p_head), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s + pad, q):
        sl = slice(c0, c0 + q)
        state, y = _ssd_chunk(state, xs_h[:, sl], bf[:, sl], cf[:, sl],
                              dtp[:, sl], ldp[:, sl], tri)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] + d_skip[None, None, :, None] \
        * xs_h[:, :s]
    y = y.reshape(bsz, s, d_l).to(x.dtype)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    y = rms_norm_split(y, p[prefix + "ssm_norm"], tp, width=d_inner)
    out = tp.reduce(y @ p[prefix + "out_proj"])
    if return_state:
        # the reference slices xbc_raw[:, s - (k - 1):s], which is short
        # for a prompt of fewer than k - 1 tokens; the zero rows the conv
        # saw before the first token make the state whole
        conv_state = F.pad(xbc_raw, (0, 0, k - 1, 0))[:, s:s + k - 1]
        return out, (state, conv_state)
    return out


def mamba2_decode(p, x, state, cfg: ModelConfig, prefix: str = "",
                  tp: TP = TP1):
    """One-token step. x: [B, 1, D]; state = (ssm [B, H, N, P] f32, conv
    [B, k - 1, C]). The conv state holds the last k - 1 PRE-conv rows (as
    ``mamba2_block(return_state=True)``), so the prefill -> decode handoff
    is exact. Returns (out [B, 1, D], (ssm, conv)), new tensors."""
    bsz = x.shape[0]
    d_inner = ssm_dims(cfg)[0]
    d_l, n_heads, p_head = _local_dims(cfg, tp)
    n = cfg.ssm_state
    ssm_state, conv_state = state
    in_proj, conv_w, conv_b, dt_bias, a_log, d_skip = _local_params(
        p, cfg, prefix, tp)

    z, xs, bmat, cmat, dt = _split_proj(tp.copy(x[:, 0]) @ in_proj, cfg,
                                        tp)
    xbc_new = torch.cat([xs, bmat, cmat], dim=-1)                 # [B, C]
    window = torch.cat([conv_state.to(xbc_new.dtype), xbc_new[:, None]],
                       dim=1)
    out = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                       conv_w.to(torch.float32)) + conv_b
    xbc = F.silu(out).to(x.dtype)
    xs, bmat, cmat = torch.split(xbc, [d_l, n, n], dim=-1)
    xs = xs.reshape(bsz, n_heads, p_head).to(torch.float32)

    dt = F.softplus(dt.to(torch.float32) + dt_bias)                # [B, H]
    dec = torch.exp(dt * -torch.exp(a_log)[None, :])
    upd = torch.einsum("bh,bs,bhp->bhsp", dt, bmat.to(torch.float32), xs)
    ssm_state = ssm_state * dec[:, :, None, None] + upd
    y = torch.einsum("bs,bhsp->bhp", cmat.to(torch.float32), ssm_state)
    y = y + d_skip[None, :, None] * xs
    y = y.reshape(bsz, d_l).to(x.dtype)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    y = rms_norm_split(y, p[prefix + "ssm_norm"], tp, width=d_inner)
    out = tp.reduce(y @ p[prefix + "out_proj"])
    return out[:, None], (ssm_state, window[:, 1:])
