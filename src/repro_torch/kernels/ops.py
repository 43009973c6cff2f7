"""Public wrappers of the kernels: ``kernel_matrix``, ``assign_fused`` and
``gram_matvec`` (the port of ``repro/kernels/ops.py:98-192``),
``embed_assign`` / ``sketch_assign`` for the explicit feature maps and
``predict_assign`` for frozen serving artifacts, which share their launch
code (the port of ``repro/kernels/ops.py:195-377``), and
``flash_attention`` for the LM zoo's prefill (the port of
``repro/kernels/ops.py:390-417``).

Each wrapper casts the tile operands to the policy's tile dtype ONCE at
entry, and the squared norms come FROM the cast values (the
``assign_fused``, ``kernel_matrix`` and ``embed_assign`` launches compute
them on the card themselves), so kernel and plain version see identical
inputs. ``assign_fused`` builds H as
one-hot(labels)/counts and puts +1e30 on empty clusters; ``embed_assign``
and ``sketch_assign`` put +1e30 on the centroid norms of empty clusters.

Dispatch is by device, and only by device: a CPU tensor runs the plain
PyTorch version (``kernels/ref.py``); a CUDA tensor launches the hand-written
kernel or raises — there is no fallback. On the card the wrappers split the
cluster axis into chunks of at most 256 (one launch each, merged by lowest
index), pad each to the kernel's multiple of 16 (zero columns of H, +1e30
in g; padded clusters can never be chosen), pad D with zero features up to the
16-byte vector width when needed, and slice the results back. The kernels
mask ragged rows and landmarks themselves, and zero the Gram columns of
landmarks past L (and the embedding columns past M), so padding never
reaches f. Block shapes are the kernels' own (``csrc/gram_f32.cuh``,
``csrc/gram_bf16.cuh``, ``csrc/embed_f32.cuh``), chosen for Hopper's
shared memory and registers — nothing here is a TPU tiling.

``LAUNCHES`` counts kernel launches per kernel (plain integers, reset by the
caller), so a run on the card can show that its main path went through the
kernels. ``WORK_OBSERVERS`` hears of each launch's work, its kind and shapes
(``launch.hlocost.KERNEL_WORK`` prices them), and of each plain call that
stands in for a launch on the CPU; when the list is empty, which it is
outside an audit, that costs one check a call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref
from .assign import CP_MULTIPLE, MAX_CP, assign_fused_cuda
from .embed_assign import embed_assign_cuda
from .flash_attention import flash_attention_cuda
from .kernel_matrix import VEC, kernel_matrix_cuda, route
from .precision import resolve_precision
from .sketch_assign import sketch_assign_cuda

BIG = 1e30   # "+inf" of empty and padded clusters that survives min/argmin

#: launches of each CUDA kernel
LAUNCHES = {"kernel_matrix": 0, "assign_fused": 0, "embed_assign": 0,
            "sketch_assign": 0, "flash_attention": 0,
            # of the kernel_matrix launches, those of the column body
            "kernel_matrix_column": 0}
#: callables ``obs(work, shapes)`` told of every launch and plain stand-in
WORK_OBSERVERS: list = []


def _work(work: str, **shapes) -> None:
    for obs in WORK_OBSERVERS:
        obs(work, shapes)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (a copy only where needed)."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _operand(a: torch.Tensor) -> torch.Tensor:
    """Contiguous, 16-byte aligned, D zero-padded to the vector width."""
    d = a.shape[1]
    dp = _round_up(d, VEC[a.dtype])
    if dp != d:
        a = F.pad(a, (0, dp - d))
    return _aligned(a)


def kernel_matrix(x: torch.Tensor, y: torch.Tensor, *, kind: str = "rbf",
                  gamma: float = 1.0, coef0: float = 1.0, degree: int = 3,
                  precision: str = "f32") -> torch.Tensor:
    """K(X, Y) -> [m, n] f32."""
    p = resolve_precision(precision)
    x, y = p.cast_tiles(x), p.cast_tiles(y)
    if WORK_OBSERVERS:
        _work("kernel_matrix", m=x.shape[0], n=y.shape[0], d=x.shape[1],
              prec=p.tile)
    if not x.is_cuda:
        return ref.kernel_matrix_ref(x, y, kind=kind, gamma=gamma,
                                     coef0=coef0, degree=degree,
                                     precision=p.tile)
    xo = _operand(x)
    yo = xo if y is x else _operand(y)
    # either body sums |x|^2 and |y|^2 in the launch
    column = route(*yo.shape) == "column"
    out = kernel_matrix_cuda(xo, yo, kind=kind, gamma=gamma, coef0=coef0,
                             degree=degree)
    LAUNCHES["kernel_matrix"] += 1
    LAUNCHES["kernel_matrix_column"] += column
    return out


def _over_cluster_chunks(panel: torch.Tensor, g: torch.Tensor, name: str,
                         launch, *, pad: bool = True, work=None):
    """Launch once per chunk of at most ``MAX_CP`` clusters (a kernel's
    on-chip accumulator), each padded to the kernel's multiple (zero panel
    columns, +1e30 in g) unless ``pad`` is False (a kernel that masks a
    ragged cluster count itself), and return (labels, best, *outputs [n,
    C]).

    ``launch(panel_chunk, g_chunk)`` returns (labels, best, *outputs [n,
    Cp]). Each column comes out the same whatever the chunking. The merge
    takes a later chunk only where it is strictly smaller, so the lowest
    cluster index still wins ties. Past 256 clusters every chunk redoes the
    chunk-independent work (the Gram tiles, the embedding). ``work`` =
    (kind, shapes but the cluster count) of each launch, for
    ``WORK_OBSERVERS``."""
    labels = best = None
    outs = []
    for c0 in range(0, panel.shape[1], MAX_CP):
        pc, gc = panel[:, c0:c0 + MAX_CP], g[c0:c0 + MAX_CP]
        c = pc.shape[1]
        if pad:
            cp = _round_up(c, CP_MULTIPLE)
            pc, gc = F.pad(pc, (0, cp - c)), F.pad(gc, (0, cp - c), value=BIG)
        lab, mn, *rest = launch(pc.contiguous(), gc.contiguous())
        LAUNCHES[name] += 1
        _chunk_work(work, c)
        outs.append([r[:, :c] for r in rest])
        if labels is None:
            labels, best = lab, mn
        else:
            better = mn < best
            labels = torch.where(better, lab + c0, labels)
            best = torch.where(better, mn, best)
    return (labels, best, *(o[0] if len(o) == 1 else torch.cat(o, dim=1)
                            for o in zip(*outs)))


def _launch_assign(x, landmarks, h, g, *, kind, gamma, coef0, degree,
                   work=None):
    """assign_fused on the card -> (labels, mind, f [n, C]); the launch
    computes the row norms (once when the g stats pass the landmark panel as
    both operands)."""
    xo = _operand(x)
    lo = xo if landmarks is x else _operand(landmarks)
    return _over_cluster_chunks(
        h, g, "assign_fused",
        lambda hc, gc: assign_fused_cuda(xo, lo, hc, gc, kind=kind,
                                         gamma=gamma, coef0=coef0,
                                         degree=degree), work=work)


def _assign_work(work: str, x, landmarks, precision: str, **extra):
    return work, dict(m=x.shape[0], l=landmarks.shape[0], d=x.shape[1],
                      prec=precision, **extra)


def assign_panels(labels_l: torch.Tensor, counts: torch.Tensor,
                  g: torch.Tensor, n_clusters: int):
    """The cluster operands of the fused assignment, the same for kernel and
    plain version: (H [L, C] = one-hot(labels_l) / counts, g [C] f32 with
    +1e30 on empty clusters)."""
    counts = counts.to(torch.float32)
    h = F.one_hot(labels_l.long(), n_clusters).to(torch.float32)
    h = h / torch.clamp(counts, min=1.0)[None, :]
    gm = torch.where(counts > 0, g.to(torch.float32),
                     torch.full_like(counts, BIG))
    return h, gm


def assign_fused(x: torch.Tensor, landmarks: torch.Tensor,
                 labels_l: torch.Tensor, counts: torch.Tensor,
                 g: torch.Tensor, *, n_clusters: int, kind: str = "rbf",
                 gamma: float = 1.0, coef0: float = 1.0, degree: int = 3,
                 precision: str = "f32"):
    """Fused Eq.15/17: (labels [n] int32, mind [n] f32, f [n, C] f32) with
    f = K(x, landmarks) @ H, H = one-hot(labels_l) / counts, and
    labels/mind = argmin/min_j (g_j - 2 f_ij), empty clusters at +1e30."""
    p = resolve_precision(precision)
    x, landmarks = p.cast_tiles(x), p.cast_tiles(landmarks)
    h, gm = assign_panels(labels_l, counts, g, n_clusters)
    work = _assign_work("assign_fused", x, landmarks, p.tile)
    if not x.is_cuda:
        _chunk_work(work, n_clusters)
        return ref.assign_fused_ref(x, landmarks, h, gm, kind=kind,
                                    gamma=gamma, coef0=coef0, degree=degree,
                                    precision=p.tile)
    return _launch_assign(x, landmarks, h, gm, kind=kind, gamma=gamma,
                          coef0=coef0, degree=degree, work=work)


def gram_matvec(x: torch.Tensor, landmarks: torch.Tensor, h: torch.Tensor, *,
                kind: str = "rbf", gamma: float = 1.0, coef0: float = 1.0,
                degree: int = 3, precision: str = "f32") -> torch.Tensor:
    """K(x, landmarks) @ h -> [n, C] f32 for any [L, C] panel h, without
    the [n, L] block in device memory: the fused assignment kernel with
    g = 0, whose argmin outputs are dropped."""
    p = resolve_precision(precision)
    # the g stats pass one panel as both operands: cast it once
    same = landmarks is x
    x = p.cast_tiles(x)
    landmarks = x if same else p.cast_tiles(landmarks)
    h = h.to(torch.float32)
    work = _assign_work("gram_matvec", x, landmarks, p.tile, shared=same)
    if not x.is_cuda:
        _chunk_work(work, h.shape[1])
        return _gram_matvec_plain(x, landmarks, h, kind=kind, gamma=gamma,
                                  coef0=coef0, degree=degree,
                                  precision=p.tile)
    zeros = torch.zeros(h.shape[1], dtype=torch.float32, device=h.device)
    return _launch_assign(x, landmarks, h, zeros, kind=kind, gamma=gamma,
                          coef0=coef0, degree=degree, work=work)[2]


@ref.kernel_scope
def _gram_matvec_plain(x, landmarks, h, **kw) -> torch.Tensor:
    """The plain version of ``gram_matvec``: the block and its product, in
    kernel scope as a whole, as the kernel never stores the block."""
    return ref.kernel_matrix_ref(x, landmarks, **kw) @ h


# ---------------------------------------------------------------------------
# explicit feature maps: fused embed + nearest-centroid assignment
# ---------------------------------------------------------------------------


def _masked_csq(centroids: torch.Tensor, counts: torch.Tensor | None):
    """(centroids f32, |c_j|^2 with +1e30 where counts == 0)."""
    c32 = centroids.to(torch.float32)
    csq = torch.sum(c32 * c32, dim=1)
    if counts is not None:
        csq = torch.where(counts > 0, csq, torch.full_like(csq, BIG))
    return c32, csq


def embed_panels(fmap, centroids: torch.Tensor,
                 counts: torch.Tensor | None = None):
    """Lower an RFF or Nystrom map and its centroids to the kernel's panels:
    (w [M, d], b [M] or None, v [M, C] f32, csq [C] f32, statics). RFF
    gives w = frequencies, b = phases, v = centroids^T; Nystrom gives
    w = landmarks, no b (kernel and plain version take |w|^2 of the cast
    tiles themselves) and v = proj @ centroids^T, in f32."""
    c32, csq = _masked_csq(centroids, counts)
    if fmap.kind == "rff":
        statics = dict(map_kind="rff", gamma=1.0, coef0=1.0, degree=1,
                       scale=fmap.scale)
        return fmap.w, fmap.b.to(torch.float32), c32.T, csq, statics
    if fmap.kind == "nystrom":
        spec = fmap.spec
        statics = dict(map_kind=spec.name, gamma=spec.gamma, coef0=spec.coef0,
                       degree=spec.degree, scale=1.0)
        return (fmap.landmarks, None, fmap.proj.to(torch.float32) @ c32.T,
                csq, statics)
    raise TypeError(f"embed_panels takes an RFF or Nystrom map, got "
                    f"{type(fmap).__name__}")


def _launch_embed(x, w, b, v, csq, statics):
    """embed_assign on the card, x and w in the tile dtype -> (labels,
    score); no norm pass: the Mercer kinds' launch sums |x|^2 and |w|^2 of
    the tile values itself, rff reads none; the f32 body masks a ragged
    cluster count itself."""
    xo, wo = _operand(x), _operand(w)
    return _over_cluster_chunks(
        v, csq, "embed_assign",
        lambda vc, cc: embed_assign_cuda(xo, wo, b, vc, cc, **statics),
        pad=x.dtype != torch.float32, work=_embed_work(x, w))


def _embed_work(x, w):
    return "embed_assign", dict(n=x.shape[0], d=x.shape[1], m=w.shape[0],
                                prec=_tile_name(x))


def _sketch_work(x, v):
    return "sketch_assign", dict(n=x.shape[0], d=x.shape[1], m=v.shape[0],
                                 prec=_tile_name(x))


def _tile_name(t: torch.Tensor) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def _chunk_work(work, c: int) -> None:
    """Tell WORK_OBSERVERS of a launch of ``work`` = (kind, shapes) over c
    clusters, or of the plain call standing in for it."""
    if WORK_OBSERVERS and work is not None:
        _work(work[0], c=c, **work[1])


def _launch_sketch(x, tables, v, csq):
    """sketch_assign on the card, x in the tile dtype -> (labels, score);
    ``tables`` = (order, offsets, sign, programs) of a map
    (``CountSketchMap.buckets`` and ``.programs``): the kernel reads the
    signs from its gather program, built once per map and dtype, so the f32
    sign table serves both dtypes."""
    order, offsets, sign, programs = tables
    xo = _operand(x)
    return _over_cluster_chunks(
        v, csq, "sketch_assign",
        lambda vc, cc: sketch_assign_cuda(xo, order, offsets, sign, vc, cc,
                                          programs=programs),
        work=_sketch_work(x, v))


def embed_assign(x: torch.Tensor, fmap, centroids: torch.Tensor,
                 counts: torch.Tensor | None = None, *,
                 precision: str = "f32"):
    """Fused feature map + nearest-centroid assignment -> (labels [n] int32,
    score [n] f32) with score = min_j |c_j|^2 - 2 phi(x_i).c_j and
    labels its argmin; ``counts`` masks empty clusters (+1e30).

    RFF and Nystrom maps go through the ``embed_assign`` kernel, the count
    sketch through ``sketch_assign``. TensorSketch has no fused kernel (its
    FFT convolution is no tile epilogue, in the reference either): it
    materializes z = fmap(x) in f32 and assigns with plain PyTorch."""
    if fmap.kind == "sketch":
        return sketch_assign(x, fmap, centroids, counts, precision=precision)
    if fmap.kind == "tensorsketch":
        c32, csq = _masked_csq(centroids, counts)
        return score_assign(fmap(x), c32.T, csq)
    w, b, v, csq, statics = embed_panels(fmap, centroids, counts)
    p = resolve_precision(precision)
    x, w = p.cast_tiles(x), p.cast_tiles(w)
    if not x.is_cuda:
        _chunk_work(_embed_work(x, w), v.shape[1])
        return ref.embed_assign_ref(x, w, v, csq, b=b, precision=p.tile,
                                    **statics)
    return _launch_embed(x, w, b, v, csq, statics)


def sketch_assign(x: torch.Tensor, fmap, centroids: torch.Tensor,
                  counts: torch.Tensor | None = None, *,
                  precision: str = "f32"):
    """Fused count-sketch + nearest-centroid assignment (dense rows), the
    contract of ``embed_assign``. The plain version takes the sign table
    in int8 under bf16; the kernel takes the signs from its gather program."""
    p = resolve_precision(precision)
    c32, csq = _masked_csq(centroids, counts)
    x = p.cast_tiles(x)
    if not x.is_cuda:
        _chunk_work(_sketch_work(x, c32.T), c32.shape[0])
        return ref.sketch_assign_ref(x, fmap.h, fmap.sign.to(p.sign_dtype),
                                     c32.T, csq, precision=p.tile)
    return _launch_sketch(x, (*fmap.buckets, fmap.programs), c32.T, csq)


def score_assign(z: torch.Tensor, v: torch.Tensor, csq: torch.Tensor):
    """argmin_j csq_j - 2 z.v_j over rows already embedded (plain PyTorch,
    for the maps with no fused kernel) -> (labels [n] int32, score [n])."""
    score = csq[None, :] - 2.0 * (z @ v.to(torch.float32))
    return (torch.argmin(score, dim=1).to(torch.int32),
            torch.amin(score, dim=1))


def predict_assign(x: torch.Tensor, w: torch.Tensor, aux: torch.Tensor,
                   v: torch.Tensor, csq: torch.Tensor, *,
                   map_kind: str = "rff", gamma: float = 1.0,
                   coef0: float = 1.0, degree: int = 3, scale: float = 1.0,
                   precision: str = "f32", tables=None):
    """The serving hot path: embed + assign one query bucket from the
    panels a frozen artifact (``serving.artifact``) built once -> (labels
    [n] int32, score [n] f32), so a request derives nothing.

    ``w``/``aux``: RFF frequencies and phases b ([m] or the artifact's
    [m, 1] column), Nystrom landmarks and their squared norms (which the
    launch and the plain version sum themselves from the tile values), or
    for ``map_kind="sketch"`` the hash h and sign tables; ``v`` [m, C] the
    value panel, ``csq`` [C] the masked centroid norms. ``w`` arrives in the
    tile dtype; x is cast to it. The count sketch on the card also takes
    ``tables``, the artifact's (order, offsets, sign, programs) with the
    gather program of its dtype already built. A CPU tensor runs
    ``ref.predict_assign_ref``; a CUDA one launches ``embed_assign`` or
    ``sketch_assign``."""
    p = resolve_precision(precision)
    x = p.cast_tiles(x)
    statics = dict(map_kind=map_kind, gamma=gamma, coef0=coef0,
                   degree=degree, scale=scale)
    if not x.is_cuda:
        _chunk_work(_sketch_work(x, v) if map_kind == "sketch"
                    else _embed_work(x, w), v.shape[1])
        return ref.predict_assign_ref(x, w, aux, v, csq, precision=p.tile,
                                      **statics)
    if map_kind == "sketch":
        if tables is None:
            raise ValueError("predict_assign on the card needs the sketch "
                             "artifact's gather tables")
        return _launch_sketch(x, tables, v, csq)
    b = aux.reshape(-1) if map_kind == "rff" else None
    return _launch_embed(x, p.cast_tiles(w), b, v, csq, statics)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


#: why a gradient through the flash kernel is refused, on either device
FLASH_NO_GRAD = ("flash_attention has no gradient: the reference's flash "
                 "kernel is forward only (one pallas_call, no backward), so "
                 "training runs attn_impl=\"chunked\"")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float | None = None,
                    precision: str = "f32") -> torch.Tensor:
    """Flash attention. q: [B, H, Sq, dh]; k/v: [B, KH, Sk, dh] (GQA). The
    softmax state and both accumulators are f32 whatever the tiles are;
    bf16 ``precision`` rounds q, k and v to bf16 once, f32 keeps their dtype
    (as the reference does). Output in the tile dtype (q's after the cast).

    Non-causal attention needs Sk % 128 == 0, the reference's condition
    (its kernel pads keys, and only the causal mask removes them). On the
    card the kernel masks ragged Sq and Sk itself; it takes a head dim
    that is a multiple of 16 up to 256 and raises on any other. Tiles of
    either dtype are read in place through their strides (dh contiguous,
    16-byte strides), and the output is a [B, H, Sq, dh] view of [B, Sq, H,
    dh] memory, so a caller holding [B, S, H, dh] activations transposes
    nothing either way.

    Forward only, on both devices: with grad mode on and q, k or v
    requiring grad it raises (``FLASH_NO_GRAD``), since the kernel's output
    has no autograd history and the reference cannot differentiate its
    kernel either."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(FLASH_NO_GRAD)
    p = resolve_precision(precision)
    if p.tile == "bf16":
        q, k, v = p.cast_tiles(q), p.cast_tiles(k), p.cast_tiles(v)
    if not causal and k.shape[2] % 128:
        raise ValueError("non-causal flash_attention requires Sk % 128 == 0")
    if WORK_OBSERVERS:
        (b, h, sq, dh), kh, sk = q.shape, k.shape[1], k.shape[2]
        _work("flash_attention", b=b, h=h, kh=kh, sq=sq, sk=sk, dh=dh,
              causal=causal, prec=_tile_name(q))
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    out = flash_attention_cuda(q, k, v, causal=causal, softcap=softcap)
    LAUNCHES["flash_attention"] += 1
    return out
