"""Shared model substrate: norms, RoPE, chunked attention, the chunked
cross-entropy and parameter initialization (the port of
``repro/models/common.py``).

Conventions
-----------
* Params are nested dicts of tensors. Where the reference stacks layers
  [n_groups, period, ...] for ``lax.scan``, the port keeps a list of
  per-layer dicts and loops over it.
* Weights keep the reference's [in, out] orientation and names, so a JAX
  parameter tree converts by unstacking alone (``repro_torch.convert``).
* The sharding annotations (``Axes``, ``shard``, partition specs) have no
  counterpart: the port's models run on one card, and ``init_*`` return
  parameters only. The ambient mesh does: ``set_ambient_mesh`` hands the
  expert-parallel MoE a ``DeviceMesh`` (``distributed/mesh.py``) with a
  ``data`` axis, and ``moe_block_ep`` then exchanges tokens over it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30   # masked scores: finite, so a fully masked row stays finite

# the ambient mesh for model code that dispatches over ranks (launchers and
# tests set it; None: one process)
_AMBIENT_MESH = None


def set_ambient_mesh(mesh) -> None:
    global _AMBIENT_MESH
    _AMBIENT_MESH = mesh


def ambient_mesh():
    return _AMBIENT_MESH


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

    def dense(self, name: str, shape, *, scale: float | None = None,
              dtype: torch.dtype | None = None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else fan_in ** -0.5
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        self.params[name] = w.to(dtype or self.dtype) * std

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


# ---------------------------------------------------------------------------
# chunked cross-entropy (full logits never materialize)
# ---------------------------------------------------------------------------


VOCAB_ALIGN = 128


def padded_vocab_size(v: int, multiple: int = VOCAB_ALIGN) -> int:
    """An odd vocabulary (seamless: 256206) padded up to an aligned
    multiple; loss and sampling mask the padded rows, so results are
    exact."""
    return -(-v // multiple) * multiple


def mask_vocab_pad(logits: torch.Tensor, n_valid: int) -> torch.Tensor:
    """-1e30 on the padded tail of a [..., V_pad] logit block."""
    vp = logits.shape[-1]
    if n_valid >= vp:
        return logits
    mask = torch.arange(vp, device=logits.device) < n_valid
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def _chunk_loss(hc, emb, lc, logit_softcap, n_valid_vocab):
    """(sum of -log p(label) over the chunk's labels >= 0, their count).
    The logits are f32 products of operands in the hidden dtype (the
    reference's ``preferred_element_type=f32``: a bf16 product is exact in
    f32, so upcasting first gives the same sums)."""
    logits = hc.to(torch.float32) @ emb.to(hc.dtype).to(torch.float32).T
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if n_valid_vocab is not None:
        logits = mask_vocab_pad(logits, n_valid_vocab)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, lc.clamp(min=0)[:, None])[:, 0]
    valid = lc >= 0
    return (torch.where(valid, lse - gold, torch.zeros_like(lse)).sum(),
            valid.sum(dtype=torch.float32))


def chunked_cross_entropy(hidden: torch.Tensor, emb: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 2048,
                          logit_softcap: float | None = None,
                          n_valid_vocab: int | None = None) -> torch.Tensor:
    """Mean CE over the labels >= 0 (-1 is padding), looping over chunks
    of ``chunk`` rows.

    hidden: [T, D] (already flattened), emb: [V, D], labels: [T]. Each
    chunk's [chunk, V] f32 logits exist only while it runs: the chunk is
    recomputed in the backward pass (``torch.utils.checkpoint``, as the
    reference's ``@jax.checkpoint``). ``n_valid_vocab`` masks padded
    embedding rows out of the partition function."""
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[0], chunk):
        s, n = checkpoint(_chunk_loss, hidden[c0:c0 + chunk], emb,
                          labels[c0:c0 + chunk], logit_softcap,
                          n_valid_vocab, use_reentrant=False)
        total, count = total + s, count + n
    return total / torch.clamp(count, min=1.0)
