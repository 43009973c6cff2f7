"""Plain PyTorch versions of the kernels (the correctness contract).

``kernel_matrix_ref``, ``assign_fused_ref``, ``embed_assign_ref``,
``sketch_assign_ref`` and ``flash_attention_ref`` compute what the CUDA
kernels compute, the straightforward way: round the tile operands to the
tile dtype (bf16 round-to-nearest-even), lift them to f32, and do all math
in f32, materializing the Gram block, the embedding or the score matrix
(``flash_attention_ref`` takes operands already in the tile dtype, as the
wrapper casts them). The argmin takes the lowest index on ties.
``embed_score_ref`` and ``sketch_score_ref`` give the whole [n, C] score
matrix that the two assignment versions reduce (for the near-tie checks);
``CALLS`` does not count them. ``predict_assign_ref`` dispatches frozen
serving panels to the two assignment versions, which count the call.

The ``ops`` wrappers run these for tensors on the CPU. On the card they run
only where ``chip_smoke.py`` holds a kernel against its plain version;
``CALLS`` counts their calls so a run on the card can show they stayed
unused on the main path. ``DEPTH`` is the number of the five calls in
progress: the program audit (``analysis.dispatch``) treats what a plain
version allocates as a kernel's on-chip tiles, never as device-memory
residency, as the reference's audit never descends into a ``pallas_call``.
"""
from __future__ import annotations

import functools

import torch

from .sketch_assign import sign_matrix

#: calls of each plain version (plain integers; reset by the caller)
CALLS = {"kernel_matrix_ref": 0, "assign_fused_ref": 0,
         "embed_assign_ref": 0, "sketch_assign_ref": 0,
         "flash_attention_ref": 0}
#: plain-version calls in progress (nested calls count each)
DEPTH = 0


def kernel_scope(fn):
    """Run ``fn`` with ``DEPTH`` raised: a plain version of a kernel."""
    @functools.wraps(fn)
    def scoped(*args, **kwargs):
        global DEPTH
        DEPTH += 1
        try:
            return fn(*args, **kwargs)
        finally:
            DEPTH -= 1
    return scoped


def _tile(a: torch.Tensor, precision: str) -> torch.Tensor:
    """Round to the tile dtype, then lift to f32 (the accumulate dtype)."""
    if precision == "bf16":
        a = a.to(torch.bfloat16)
    return a.to(torch.float32)


@kernel_scope
def kernel_matrix_ref(x: torch.Tensor, y: torch.Tensor, *, kind: str = "rbf",
                      gamma: float = 1.0, coef0: float = 1.0, degree: int = 3,
                      precision: str = "f32") -> torch.Tensor:
    """K(X, Y) -> [m, n] f32, f32 math over tile-dtype operands."""
    CALLS["kernel_matrix_ref"] += 1
    xf = _tile(x, precision)
    yf = _tile(y, precision)
    dot = xf @ yf.T
    if kind == "linear":
        return dot
    if kind == "polynomial":
        return (gamma * dot + coef0) ** degree
    if kind == "cosine":
        xn = torch.sqrt(torch.sum(xf * xf, dim=1))[:, None]
        yn = torch.sqrt(torch.sum(yf * yf, dim=1))[None, :]
        return dot / torch.clamp(xn * yn, min=1e-12)
    if kind == "rbf":
        d2 = (torch.sum(xf * xf, dim=1)[:, None]
              + torch.sum(yf * yf, dim=1)[None, :] - 2.0 * dot)
        return torch.exp(-gamma * torch.clamp(d2, min=0.0))
    raise ValueError(f"unknown kernel kind {kind!r}")


@kernel_scope
def assign_fused_ref(x: torch.Tensor, landmarks: torch.Tensor,
                     h_norm: torch.Tensor, g: torch.Tensor, *,
                     kind: str = "rbf", gamma: float = 1.0,
                     coef0: float = 1.0, degree: int = 3,
                     precision: str = "f32"):
    """x: [n, d]; landmarks: [L, d]; h_norm: [L, C] one-hot/counts;
    g: [C] compactness (+1e30 on empty clusters).
    Returns (labels [n] int32, mind [n] f32, f [n, C] f32) with
      f = K(x, landmarks) @ h_norm            (Eq.17)
      labels = argmin_j g_j - 2 f_ij          (Eq.15, lowest index on ties)
    """
    CALLS["assign_fused_ref"] += 1
    k = kernel_matrix_ref(x, landmarks, kind=kind, gamma=gamma, coef0=coef0,
                          degree=degree, precision=precision)
    f = k @ h_norm.to(torch.float32)
    return (*_reduce(g[None, :].to(torch.float32) - 2.0 * f), f)


def _reduce(score: torch.Tensor):
    # torch.argmin returns the first (lowest) index among tied minima
    return torch.argmin(score, dim=1).to(torch.int32), torch.amin(score, dim=1)


def embed_score_ref(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    csq: torch.Tensor, *, map_kind: str = "rff",
                    gamma: float = 1.0, coef0: float = 1.0, degree: int = 3,
                    scale: float = 1.0, b: torch.Tensor | None = None,
                    precision: str = "f32") -> torch.Tensor:
    """The whole score matrix [n, C] that ``embed_assign_ref`` reduces:
      e = scale cos(x w^T + b)  or  K(x, w)      the embedding phi_m(x)
      score_ij = |c_j|^2 - 2 (e v)_ij."""
    if map_kind == "rff":
        a = _tile(x, precision) @ _tile(w, precision).T
        e = scale * torch.cos(a + b.to(torch.float32)[None, :])
    else:
        e = kernel_matrix_ref(x, w, kind=map_kind, gamma=gamma, coef0=coef0,
                              degree=degree, precision=precision)
    return csq[None, :].to(torch.float32) - 2.0 * (e @ v.to(torch.float32))


@kernel_scope
def embed_assign_ref(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                     csq: torch.Tensor, **kw):
    """x: [n, d]; w: [M, d] RFF frequencies (map_kind "rff", phases ``b``
    [M]) or Nystrom landmarks (map_kind a Mercer kind); v: [M, C] value
    panel; csq: [C] centroid squared norms (+1e30 on masked clusters); the
    keywords of ``embed_score_ref``. Returns (labels [n] int32, score [n]
    f32): the min of ``embed_score_ref`` over j and its lowest argmin."""
    CALLS["embed_assign_ref"] += 1
    return _reduce(embed_score_ref(x, w, v, csq, **kw))


def sketch_score_ref(x: torch.Tensor, h: torch.Tensor, sign: torch.Tensor,
                     v: torch.Tensor, csq: torch.Tensor, *,
                     precision: str = "f32") -> torch.Tensor:
    """The whole score matrix [n, C] that ``sketch_assign_ref`` reduces:
      z_j = sum_{i: h_i = j} sign_i x_i,  score = |c_j|^2 - 2 (z v)_ij."""
    z = _tile(x, precision) @ sign_matrix(h, sign, v.shape[0])
    return csq[None, :].to(torch.float32) - 2.0 * (z @ v.to(torch.float32))


@kernel_scope
def sketch_assign_ref(x: torch.Tensor, h: torch.Tensor, sign: torch.Tensor,
                      v: torch.Tensor, csq: torch.Tensor, *,
                      precision: str = "f32"):
    """x: [n, d]; h: [d] bucket ids (-1 lands nowhere); sign: [d] +-1 (f32,
    or int8 under bf16); v: [m, C] value panel; csq: [C].
    Returns (labels [n] int32, score [n] f32): the min of
    ``sketch_score_ref`` over j and its lowest argmin."""
    CALLS["sketch_assign_ref"] += 1
    return _reduce(sketch_score_ref(x, h, sign, v, csq, precision=precision))


def predict_assign_ref(x: torch.Tensor, w: torch.Tensor, aux: torch.Tensor,
                       v: torch.Tensor, csq: torch.Tensor, *,
                       map_kind: str = "rff", gamma: float = 1.0,
                       coef0: float = 1.0, degree: int = 3,
                       scale: float = 1.0, precision: str = "f32"):
    """The plain version of ``ops.predict_assign`` over frozen panels:
    ``sketch_assign_ref`` for map_kind "sketch" (w = h, aux = sign), else
    ``embed_assign_ref`` (w = RFF frequencies with aux the phases, [m] or
    [m, 1], or Nystrom landmarks, whose norms ``aux`` holds and
    ``kernel_matrix_ref`` sums again from the tile values)."""
    if map_kind == "sketch":
        return sketch_assign_ref(x, w, aux, v, csq, precision=precision)
    b = aux.reshape(-1) if map_kind == "rff" else None
    return embed_assign_ref(x, w, v, csq, map_kind=map_kind, gamma=gamma,
                            coef0=coef0, degree=degree, scale=scale, b=b,
                            precision=precision)


@kernel_scope
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        softcap: float | None = None) -> torch.Tensor:
    """Attention, the port of ``repro/kernels/ref.py:143``. q: [B, H, Sq,
    dh]; k/v: [B, KH, Sk, dh] (GQA: head h reads kv head h // (H / KH)).
    f32 math, softcap as cap tanh(s / cap), a top-left causal mask with
    -1e30 on masked scores; returns q's dtype."""
    CALLS["flash_attention_ref"] += 1
    sq, dh = q.shape[2], q.shape[3]
    sk = k.shape[2]
    groups = q.shape[1] // k.shape[1]
    kx = torch.repeat_interleave(k, groups, dim=1).to(torch.float32)
    vx = torch.repeat_interleave(v, groups, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kx) * dh ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)
