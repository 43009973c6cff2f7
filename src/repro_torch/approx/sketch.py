"""Data-oblivious sketch feature maps: count-sketch and TensorSketch, the
port of ``repro/approx/sketch.py``.

Count-sketch (feature hashing) for the **linear** kernel: with a bucket hash
``h: [d] -> [m]`` and Rademacher signs ``s``,

    z(x)_j = sum_{i : h(i) = j} s_i x_i         E[z(x) . z(y)] = x . y.

TensorSketch for the **polynomial** kernel ``(gamma x.y + coef0)^p``:
count-sketch the augmented input ``x' = [sqrt(gamma) x, sqrt(coef0)]`` with
p independent hash pairs and multiply in Fourier space,

    z(x) = IFFT( prod_k FFT(CS_k(x')) )         E[z(x).z(y)] = (x'.y')^p.

Both maps take dense rows or a CSR batch (``data/sparse.py``). On a CSR
batch the application touches only the stored values, O(nnz) and free of
d (``*_features_csr``); the reference computes that scatter in plain jnp,
outside any Pallas kernel, and so does the port, in PyTorch ops on the
batch's device. A scatter-add (``index_add_``) on the card sums through
atomics in no fixed order, which would make a seeded fit unrepeatable, so
the route here is a **stable sort of the target slots followed by a
segment sum** (``_scatter_sum``): each output slot sums its values in the
order the batch stores them, on the CPU and on the card, run after run.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.data.sparse import as_csr, is_sparse, row_ids
from repro_torch.device import resolve_device
from repro_torch.kernels.sketch_assign import bucket_tables, sign_matrix

#: the maps that embed a CSR batch in O(nnz); the others need dense rows
SKETCH_KINDS = ("sketch", "tensorsketch")


def check_dense(method: str, x) -> None:
    """The reference's refusal of a CSR batch ``x`` for the maps that need
    dense rows (RFF and Nystrom), raised as the reference raises it."""
    if is_sparse(x) and method not in SKETCH_KINDS:
        raise ValueError(
            f"method {method!r} needs dense samples; only the sketch maps "
            "('sketch' | 'tensorsketch') accept CSR batches")


@dataclasses.dataclass(frozen=True, eq=False)
class CountSketchMap:
    """Frozen count-sketch: z(x)_j = sum_{i: h_i = j} sign_i * x_i."""

    h: torch.Tensor      # [d] int32 bucket per input coordinate
    sign: torch.Tensor   # [d] f32 Rademacher signs
    m: int               # embedding dim

    kind = "sketch"

    @property
    def dim(self) -> int:
        return self.m

    @property
    def in_dim(self) -> int:
        return self.h.shape[0]

    @functools.cached_property
    def matrix(self) -> torch.Tensor:
        """The sketch as a [d, m] signed one-hot matrix, built once per map:
        z = x @ matrix sums each bucket in a fixed order, so two runs agree
        bitwise (a scatter-add on the card sums in no fixed order)."""
        return sign_matrix(self.h, self.sign, self.m)

    @functools.cached_property
    def buckets(self):
        """The columns sorted by bucket for the ``sketch_assign`` kernel:
        (order, offsets, sign in that order), built once per map."""
        return bucket_tables(self.h, self.sign, self.m)

    @functools.cached_property
    def programs(self) -> dict:
        """The ``sketch_assign`` kernel's gather programs of ``buckets``
        by chunk width, built at a dtype's first launch, once per map."""
        return {}

    def __call__(self, x) -> torch.Tensor:
        if is_sparse(x):
            return count_sketch_features_csr(as_csr(x).to(self.h.device),
                                             self)
        return count_sketch_features(x, self)


@dataclasses.dataclass(frozen=True, eq=False)
class TensorSketchMap:
    """Frozen TensorSketch for ``(gamma x.y + coef0)^degree``: ``hs`` and
    ``signs`` are [degree, d + 1], one count-sketch per polynomial factor,
    the last column sketching the constant sqrt(coef0) coordinate."""

    hs: torch.Tensor      # [p, d+1] int32
    signs: torch.Tensor   # [p, d+1] f32
    m: int
    degree: int
    gamma: float
    coef0: float

    kind = "tensorsketch"

    @property
    def dim(self) -> int:
        return self.m

    @property
    def in_dim(self) -> int:
        return self.hs.shape[1] - 1

    @functools.cached_property
    def matrices(self) -> torch.Tensor:
        """[degree, d + 1, m]: each factor's sketch as a signed one-hot
        matrix (see ``CountSketchMap.matrix``)."""
        return torch.stack([sign_matrix(h, s, self.m)
                            for h, s in zip(self.hs, self.signs)])

    def __call__(self, x) -> torch.Tensor:
        if is_sparse(x):
            return tensor_sketch_features_csr(
                as_csr(x).to(self.hs.device), self)
        return tensor_sketch_features(x, self)


def _rademacher(gen: torch.Generator, shape) -> torch.Tensor:
    return (torch.randint(0, 2, shape, generator=gen) * 2 - 1).to(
        torch.float32)


def make_count_sketch(gen: torch.Generator, d: int, m: int, spec, *,
                      device=None) -> CountSketchMap:
    """Sample an m-bucket count-sketch over R^d (linear kernel only) from
    the CPU generator ``gen``; the tables go to ``device`` (``None``: the
    card, raising without one)."""
    device = resolve_device(device)
    if spec.name != "linear":
        raise ValueError(
            f"count-sketch approximates the linear kernel; got {spec.name!r} "
            "(use method='tensorsketch' for polynomial, 'rff'/'nystrom' "
            "for rbf)")
    if m < 1:
        raise ValueError(f"embedding dim m must be >= 1, got {m}")
    h = torch.randint(0, m, (d,), generator=gen, dtype=torch.int32)
    sign = _rademacher(gen, (d,))
    return CountSketchMap(h=h.to(device), sign=sign.to(device), m=m)


def make_tensor_sketch(gen: torch.Generator, d: int, m: int, spec, *,
                       device=None) -> TensorSketchMap:
    """Sample a degree-``spec.degree`` TensorSketch over R^d (polynomial
    kernel with gamma > 0 and coef0 >= 0) from the CPU generator ``gen``;
    the tables go to ``device`` (``None``: the card, raising without one)."""
    device = resolve_device(device)
    if spec.name != "polynomial":
        raise ValueError(
            f"TensorSketch approximates the polynomial kernel; got "
            f"{spec.name!r}")
    if spec.gamma <= 0 or spec.coef0 < 0:
        raise ValueError(
            f"TensorSketch needs gamma > 0 and coef0 >= 0, got "
            f"gamma={spec.gamma}, coef0={spec.coef0}")
    if m < 1:
        raise ValueError(f"embedding dim m must be >= 1, got {m}")
    if spec.degree < 1:
        raise ValueError(f"polynomial degree must be >= 1, got {spec.degree}")
    p = spec.degree
    hs = torch.randint(0, m, (p, d + 1), generator=gen, dtype=torch.int32)
    signs = _rademacher(gen, (p, d + 1))
    return TensorSketchMap(hs=hs.to(device), signs=signs.to(device), m=m,
                           degree=p, gamma=spec.gamma, coef0=spec.coef0)


def count_sketch_features(x: torch.Tensor, fmap: CountSketchMap):
    """z(X) -> [n, m] f32."""
    return x.to(torch.float32) @ fmap.matrix


def tensor_sketch_features(x: torch.Tensor, fmap: TensorSketchMap):
    """z(X) -> [n, m] f32 via the FFT product of per-factor sketches."""
    n = x.shape[0]
    x_aug = torch.cat(
        [x.to(torch.float32) * math.sqrt(fmap.gamma),
         torch.full((n, 1), math.sqrt(fmap.coef0), dtype=torch.float32,
                    device=x.device)], dim=1)
    prod = None
    for s in fmap.matrices:
        f = torch.fft.fft(x_aug @ s, dim=1)
        prod = f if prod is None else prod * f
    return torch.fft.ifft(prod, dim=1).real.to(torch.float32)


# ---------------------------------------------------------------------------
# application to CSR batches, O(nnz)
# ---------------------------------------------------------------------------


def _scatter_sum(batch, h: torch.Tensor, vals: torch.Tensor,
                 m: int) -> torch.Tensor:
    """[n, m] f32: slot (r, j) is the sum of ``vals`` over row r's stored
    values whose column hashes to j, in the batch's stored order. The
    slots' keys ``r*m + h[col]`` are sorted stably and summed segment by
    segment (``torch.segment_reduce``); no atomics, so the result is
    bitwise repeatable on the card. Slack slots (row id n) key past every
    segment and add nothing."""
    n, dev = batch.shape[0], vals.device
    key = row_ids(batch) * m + h[batch.indices.long()].long()
    key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        key, torch.arange(n * m + 1, dtype=torch.int64, device=dev))
    z = torch.segment_reduce(vals[order][:, None], "sum", offsets=offsets,
                             axis=0)
    return z.reshape(n, m)


def count_sketch_features_csr(batch, fmap: CountSketchMap) -> torch.Tensor:
    """z(X) -> [n, m] f32 touching only the stored values: each lands in
    slot (row, h[col]) with its sign; nothing scales with d."""
    cols = batch.indices.long()
    vals = batch.data.to(torch.float32) * fmap.sign[cols]
    return _scatter_sum(batch, fmap.h, vals, fmap.m)


def tensor_sketch_features_csr(batch, fmap: TensorSketchMap) -> torch.Tensor:
    """z(X) -> [n, m] f32 in O(p (nnz + n m log m)), free of d. The
    constant sqrt(coef0) coordinate of the augmented input is dense in
    every row: it is added as a one-hot after the sparse scatter."""
    m, d = fmap.m, fmap.in_dim
    cols = batch.indices.long()
    scaled = batch.data.to(torch.float32) * math.sqrt(fmap.gamma)
    prod = None
    for h, s in zip(fmap.hs, fmap.signs):
        cs = _scatter_sum(batch, h, scaled * s[cols], m)
        const = s[d] * math.sqrt(fmap.coef0) * F.one_hot(
            h[d].long(), m).to(torch.float32)
        f = torch.fft.fft(cs + const[None, :], dim=1)
        prod = f if prod is None else prod * f
    return torch.fft.ifft(prod, dim=1).real.to(torch.float32)
