"""Shared model substrate: norms, RoPE, chunked attention and parameter
initialization (the port of ``repro/models/common.py``).

Conventions
-----------
* Params are nested dicts of tensors. Where the reference stacks layers
  [n_groups, period, ...] for ``lax.scan``, the port keeps a list of
  per-layer dicts and loops over it.
* Weights keep the reference's [in, out] orientation and names, so a JAX
  parameter tree converts by unstacking alone (``repro_torch.convert``).
* The sharding annotations (``Axes``, ``shard``, partition specs, the ambient
  mesh) belong to the mesh slice; the port has none of them yet, and
  ``init_*`` return parameters only. The chunked cross-entropy waits for the
  training slice.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30   # masked scores: finite, so a fully masked row stays finite


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Collects a params dict, drawing from one ``torch.Generator`` as it
    goes. ``dense`` draws normal x fan_in^-1/2 (or ``scale``) in f32 and
    rounds to the builder's dtype, as the reference's ``dense_init`` does;
    norm weights are f32 whatever the dtype."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.params: dict = {}

    def dense(self, name: str, shape, *, scale: float | None = None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else fan_in ** -0.5
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        self.params[name] = w.to(self.dtype) * std

    def zeros(self, name: str, shape):
        self.params[name] = torch.zeros(shape, dtype=torch.float32,
                                        device=self.device)

    def ones(self, name: str, shape):
        self.params[name] = torch.ones(shape, dtype=torch.float32,
                                       device=self.device)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None, *,
             eps: float = 1e-6, plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32; ``weight=None`` -> OLMo's non-parametric LN (no
    affine). ``plus_one`` -> gemma-style (1 + w) parameterization."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if weight is not None:
        w = weight.to(torch.float32)
        y = y * (1.0 + w if plus_one else w)
    return y.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.to(torch.float32)).to(gate.dtype) * up


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: broadcastable to [..., S]. Rotates
    the two halves of each head (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # [dh/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, dh/2]
    angles = angles[..., None, :]                      # [..., S, 1, dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked causal attention (plain PyTorch; memory O(chunk * S))
# ---------------------------------------------------------------------------


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      attn_softcap: float | None = None, q_chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, dh], k/v: [B, Sk, KH, dh] (GQA: H % KH == 0).

    Loops over query chunks; scores for one chunk are [B, KH, G, cq, Sk] in
    f32 — the full [Sq, Sk] score matrix never materializes. ``window``
    adds a local (sliding-window) mask; ``q_offset`` is the absolute
    position of q[0] (prefill continuation / decode)."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    groups = h // kh
    scale = dh ** -0.5
    cq = min(q_chunk, sq)
    kpos = torch.arange(sk, device=q.device)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for c0 in range(0, sq, cq):
        qc = q[:, c0:c0 + cq]
        n = qc.shape[1]
        qpos = q_offset + c0 + torch.arange(n, device=q.device)
        qg = qc.reshape(b, n, kh, groups, dh).to(torch.float32)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
        if attn_softcap is not None:
            scores = attn_softcap * torch.tanh(scores / attn_softcap)
        mask = torch.ones((n, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, vf)
        outs.append(out.reshape(b, n, h, dh).to(q.dtype))
    return torch.cat(outs, dim=1)
