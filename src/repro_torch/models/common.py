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
* The reference's ``Axes`` and ambient mesh (its GSPMD annotations) are
  ``TP`` here: the model axis of a ``DeviceMesh`` (``distributed/mesh.py``)
  that every family of the zoo splits over, Megatron-style.
  Every function that splits takes ``tp=`` (default ``TP1``: one rank, no
  collective, the unsplit code). Under ``TP`` of size M a rank holds the
  parameters ``convert.shard_lm`` cuts for it, the residual stream is
  whole on every rank, a split region starts at ``tp.copy`` (identity,
  all_reduce backward) and ends at ``tp.reduce`` (all_reduce, identity
  backward). A replicated parameter used inside a region goes through
  ``tp.copy`` too, so its gradient is the whole one on every rank. A
  model axis wider than a family's heads splits each head over
  ``tp.group(heads)`` ranks (mid-head); the rank gathers its group's
  head whole with ``tp.all_gather``, whose backward sums the ranks'
  partial gradients. ``init_*`` return parameters only. ``TP``'s mesh
  also hands the expert-parallel MoE its ``data`` axis.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30   # masked scores: finite, so a fully masked row stays finite

@dataclasses.dataclass(frozen=True)
class TP:
    """The model axis a model splits over: ``mesh`` (a DeviceMesh with a
    ``model`` axis, or None), its ``size`` and this rank's ``rank`` on
    it. At size 1 every method is the identity and launches nothing."""
    mesh: object = None
    size: int = 1
    rank: int = 0

    @classmethod
    def of(cls, mesh) -> "TP":
        from repro_torch.distributed import mesh as dmesh
        if mesh is None or "model" not in mesh.mesh_dim_names:
            return TP1
        return cls(mesh, dmesh.axis_size(mesh, "model"),
                   dmesh.axis_rank(mesh, "model"))

    def local(self, n: int, what: str) -> int:
        """n / size, raising when ``what`` (n of them) does not split."""
        if n % self.size:
            raise ValueError(f"{n} {what} do not split over a model axis "
                             f"of {self.size}")
        return n // self.size

    def group(self, n_heads: int) -> int:
        """r, the ranks that share each of ``n_heads`` heads: 1 when the
        axis splits whole heads (M divides the heads), M / n_heads when it
        splits each head mid-head over r consecutive ranks (the heads
        divide M; ``registry.check_heads`` refuses every other pair)."""
        return self.size // n_heads if self.size > n_heads else 1

    def copy(self, t):
        if self.size == 1:
            return t
        from repro_torch.distributed import mesh as dmesh
        return dmesh.copy_to_model(t, self.mesh)

    def reduce(self, t):
        if self.size == 1:
            return t
        from repro_torch.distributed import mesh as dmesh
        return dmesh.reduce_from_model(t, self.mesh)

    def gather(self, t, dim: int):
        """Every rank's block along ``dim``, whole (replicated)."""
        if self.size == 1:
            return t
        from repro_torch.distributed import mesh as dmesh
        return dmesh.gather_from_model(t, self.mesh, dim)

    def all_gather(self, t, dim: int):
        """Every rank's block along ``dim``, inside a split region whose
        gradients are partial sums (one all_gather; backward
        reduce_scatters the ranks' partial gradients): how a mid-head
        split makes a group's head whole on every rank of the group."""
        if self.size == 1:
            return t
        from repro_torch.distributed import mesh as dmesh
        return dmesh.all_gather_dim(t, self.mesh, dim)

    def split(self, t, dim: int):
        """This rank's block of a replicated tensor along ``dim``."""
        if self.size == 1:
            return t
        from repro_torch.distributed import mesh as dmesh
        return dmesh.split_to_model(t, self.mesh, dim)

    def scatter(self, t, dim: int):
        """This rank's block along ``dim`` of the ranks' partial sums
        (one reduce_scatter; backward all_gathers the blocks' grads)."""
        if self.size == 1:
            return t
        from repro_torch.distributed import mesh as dmesh
        return dmesh.reduce_scatter(t, self.mesh, dim)

    def max(self, t):
        if self.size == 1:
            return t
        from repro_torch.distributed import mesh as dmesh
        return dmesh.all_reduce_max(t, self.mesh)


TP1 = TP()


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


def rms_norm_split(x: torch.Tensor, weight: torch.Tensor, tp: TP, *,
                   width: int, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 over a width split over the model axis: x and
    ``weight`` hold this rank's block of ``width`` columns; the sum of
    squares is all-reduced (whole on every rank, its gradient summed).
    At one rank it is ``rms_norm``."""
    if tp.size == 1:
        return rms_norm(x, weight, eps=eps)
    x32 = x.to(torch.float32)
    ss = tp.copy(tp.reduce(torch.sum(x32 * x32, dim=-1, keepdim=True)))
    y = x32 * torch.rsqrt(ss / width + eps) * weight.to(torch.float32)
    return y.to(x.dtype)


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor,
                 tp: TP = TP1) -> torch.Tensor:
    """Rows of the embedding for ``tokens``. Split over the model axis
    (rank r holds rows [r V/M, (r + 1) V/M)), each rank looks up its own
    rows, zeroes the others and the ranks' rows are summed."""
    if tp.size == 1:
        return emb[tokens]
    vl = emb.shape[0]
    local = tokens - tp.rank * vl
    own = (local >= 0) & (local < vl)
    x = emb[local.clamp(0, vl - 1)]
    return tp.reduce(torch.where(own[..., None], x, torch.zeros_like(x)))


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


def _chunk_loss_split(hc, emb, lc, logit_softcap, n_valid_vocab, tp):
    """``_chunk_loss`` with the vocabulary split over the model axis: emb
    holds this rank's rows; the row maxima, the sums of exponentials and
    the gold logits are combined over the ranks, and the padded tail is
    masked by its global vocabulary index."""
    vl = emb.shape[0]
    v0 = tp.rank * vl
    logits = hc.to(torch.float32) @ emb.to(hc.dtype).to(torch.float32).T
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if n_valid_vocab is not None and v0 + vl > n_valid_vocab:
        gid = v0 + torch.arange(vl, device=logits.device)
        logits = torch.where(gid < n_valid_vocab, logits,
                             torch.full_like(logits, NEG_INF))
    m = tp.max(torch.max(logits, dim=-1).values.detach())
    se = tp.reduce(torch.sum(torch.exp(logits - m[:, None]), dim=-1))
    lse = m + torch.log(se)
    local = lc - v0
    own = (local >= 0) & (local < vl)
    gold = torch.gather(logits, 1, local.clamp(0, vl - 1)[:, None])[:, 0]
    gold = tp.reduce(torch.where(own, gold, torch.zeros_like(gold)))
    valid = lc >= 0
    return (torch.where(valid, lse - gold, torch.zeros_like(lse)).sum(),
            valid.sum(dtype=torch.float32))


def chunked_cross_entropy(hidden: torch.Tensor, emb: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 2048,
                          logit_softcap: float | None = None,
                          n_valid_vocab: int | None = None,
                          tp: TP = TP1) -> torch.Tensor:
    """Mean CE over the labels >= 0 (-1 is padding), looping over chunks
    of ``chunk`` rows.

    hidden: [T, D] (already flattened), emb: [V, D], labels: [T]. Each
    chunk's [chunk, V] f32 logits exist only while it runs: the chunk is
    recomputed in the backward pass (``torch.utils.checkpoint``, as the
    reference's ``@jax.checkpoint``). ``n_valid_vocab`` masks padded
    embedding rows out of the partition function. Under ``tp`` of more
    than one rank, emb holds this rank's block of vocabulary rows
    (``_chunk_loss_split``)."""
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    fn, extra = _chunk_loss, ()
    if tp.size > 1:
        fn, extra, hidden = _chunk_loss_split, (tp,), tp.copy(hidden)
    for c0 in range(0, hidden.shape[0], chunk):
        s, n = checkpoint(fn, hidden[c0:c0 + chunk], emb,
                          labels[c0:c0 + chunk], logit_softcap,
                          n_valid_vocab, *extra, use_reentrant=False)
        total, count = total + s, count + n
    return total / torch.clamp(count, min=1.0)
