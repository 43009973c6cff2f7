"""CSR mini-batches for the embedded (sketch) path, the port of
``repro/data/sparse.py``.

High-dimensional sparse rows (RCV1-style log TF-IDF: d ~ 50k, tens of
nonzeros a document) cannot afford the dense [n, d] batch the RFF /
Nystrom maps consume, but the count-sketch maps (``approx/sketch.py``)
touch only the stored coordinates, so embedding a batch that stays sparse
costs O(nnz).

``CSRBatch`` holds the three tensors (data f32, indices int32, indptr
int32 or int64) and the logical (n, d) shape; ``to_dense`` is the oracle
every sparse code path is tested against. The helpers (``csr_from_dense``,
``take_rows``, ``split_csr``, ``slice_rows``, ``concat_csr``,
``pad_csr_capacity``, ``shard_csr``) are PyTorch ops on the batch's own
device; the ingestion path calls them on host tensors, before staging.
Helpers that build a new indptr build it in int64.

Capacity contract: a ``CSRBatch`` may carry *slack* stored slots at
positions >= ``indptr[-1]`` that belong to no row (zero data, column 0).
``shard_csr`` uses them to give every shard one stored-slot count, and the
serving path to pad a request to a power-of-two rung; ``to_dense`` and
every other consumer honour only ``data[:indptr[-1]]``, and in the O(nnz)
sketch a slack slot's row id is n, past every output slot.

Batches from outside the port (the reference's ``CSRBatch``, a scipy CSR
matrix, a torch ``sparse_csr`` tensor) are converted by ``as_csr`` through
their arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sampling import batch_indices


@dataclasses.dataclass(frozen=True, eq=False)
class CSRBatch:
    """Compressed-sparse-row batch: row i owns data[indptr[i]:indptr[i+1]].

    ``data`` [nnz] f32, ``indices`` [nnz] int32 column ids, ``indptr``
    [n+1] int32 or int64 row offsets, all on one device; ``shape`` = (n, d).
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        """Stored slots, including any slack capacity (module docstring)."""
        return int(self.data.shape[0])

    def __len__(self) -> int:
        return int(self.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def tensors(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.data, self.indices, self.indptr

    def to(self, device, *, non_blocking: bool = False) -> "CSRBatch":
        """The batch on ``device`` (no copy where it already lies there)."""
        data, indices, indptr = (t.to(device, non_blocking=non_blocking)
                                 for t in self.tensors())
        return CSRBatch(data, indices, indptr, self.shape)


def is_sparse(x) -> bool:
    """A CSR batch: the port's ``CSRBatch``, a torch ``sparse_csr`` tensor,
    or anything with an ``indptr`` (the reference's ``CSRBatch``, a scipy
    CSR matrix)."""
    return isinstance(x, CSRBatch) or getattr(
        x, "layout", None) == torch.sparse_csr or hasattr(x, "indptr")


def _tensor(a, dtype) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(dtype)
    return torch.from_numpy(np.asarray(a)).to(dtype)


def as_csr(x) -> CSRBatch:
    """Any CSR batch ``is_sparse`` accepts -> the port's ``CSRBatch``
    (data f32, indices int32; a foreign batch's arrays on the CPU)."""
    if isinstance(x, CSRBatch):
        return x
    if getattr(x, "layout", None) == torch.sparse_csr:
        return CSRBatch(x.values().to(torch.float32),
                        x.col_indices().to(torch.int32),
                        x.crow_indices(), (int(x.shape[0]), int(x.shape[1])))
    indptr = np.asarray(x.indptr)
    return CSRBatch(_tensor(x.data, torch.float32),
                    _tensor(x.indices, torch.int32),
                    _tensor(indptr, torch.int64 if indptr.dtype == np.int64
                            else torch.int32),
                    (int(x.shape[0]), int(x.shape[1])))


def _ptr(batch: CSRBatch) -> torch.Tensor:
    return batch.indptr.to(torch.int64)


def stored(batch: CSRBatch) -> int:
    """Stored slots that belong to rows (``indptr[-1]``)."""
    return int(batch.indptr[-1])


def csr_from_dense(x) -> CSRBatch:
    """Dense [n, d] (numpy or tensor) -> CSRBatch on the same device."""
    x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    if x.ndim != 2:
        raise ValueError(f"need a 2-d array, got shape {tuple(x.shape)}")
    rows, cols = torch.nonzero(x, as_tuple=True)      # row-major order
    indptr = torch.searchsorted(
        rows, torch.arange(x.shape[0] + 1, device=x.device))
    return CSRBatch(x[rows, cols].to(torch.float32), cols.to(torch.int32),
                    indptr, (int(x.shape[0]), int(x.shape[1])))


def to_dense(batch: CSRBatch) -> torch.Tensor:
    """CSRBatch -> dense [n, d] f32 on its device, the round-trip oracle.
    Honours the capacity contract: only ``data[:indptr[-1]]`` is row
    payload."""
    batch = as_csr(batch)
    n, d = batch.shape
    ptr = _ptr(batch)
    k = stored(batch)
    out = torch.zeros((n, d), dtype=torch.float32, device=batch.device)
    rows = torch.repeat_interleave(
        torch.arange(n, device=batch.device), torch.diff(ptr))
    out[rows, batch.indices[:k].long()] = batch.data[:k].to(torch.float32)
    return out


def row_ids(batch: CSRBatch) -> torch.Tensor:
    """[nnz] int64 row id of every stored slot; a slack slot's is n."""
    pos = torch.arange(batch.nnz, device=batch.device)
    return torch.searchsorted(_ptr(batch), pos, right=True) - 1


def take_rows(batch: CSRBatch, idx) -> CSRBatch:
    """Select rows ``idx`` (per-row order kept); one gather of the
    selected rows' stored slots."""
    dev = batch.device
    idx = torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx)
                          else idx, dtype=torch.int64, device=dev)
    ptr = _ptr(batch)
    lens = torch.diff(ptr)[idx]
    new_ptr = torch.zeros(len(idx) + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=new_ptr[1:])
    total = int(new_ptr[-1])
    # output slot t of new row r gathers ptr[idx[r]] + (t - new_ptr[r])
    gather = torch.repeat_interleave(ptr[idx] - new_ptr[:-1], lens,
                                     output_size=total) + torch.arange(
        total, device=dev)
    return CSRBatch(batch.data[gather].to(torch.float32),
                    batch.indices[gather].to(torch.int32), new_ptr,
                    (int(len(idx)), batch.shape[1]))


def split_csr(batch: CSRBatch, n_batches: int,
              strategy: str = "stride") -> list[CSRBatch]:
    """Stride/block split into mini-batches: the index sets of
    ``sampling.split_batches`` on the dense oracle."""
    return [take_rows(batch, idx)
            for idx in batch_indices(len(batch), n_batches, strategy)]


def slice_rows(batch: CSRBatch, start: int, stop: int) -> CSRBatch:
    """Contiguous row slice [start, stop): data and indices stay views, the
    streaming re-chunker copies each row's payload once, at assembly."""
    n = batch.shape[0]
    start, stop = max(0, min(n, int(start))), max(0, min(n, int(stop)))
    if stop < start:
        raise ValueError(f"need start <= stop, got [{start}, {stop})")
    ptr = _ptr(batch)[start:stop + 1]
    lo, hi = int(ptr[0]), int(ptr[-1])
    return CSRBatch(batch.data[lo:hi].to(torch.float32),
                    batch.indices[lo:hi].to(torch.int32), ptr - lo,
                    (stop - start, batch.shape[1]))


def concat_csr(parts: list[CSRBatch]) -> CSRBatch:
    """Row-stack CSR batches: per-part offsets accumulate, slack capacity
    is dropped."""
    if not parts:
        raise ValueError("need at least one CSRBatch to concatenate")
    d = parts[0].shape[1]
    if any(p.shape[1] != d for p in parts):
        raise ValueError(
            f"column counts differ: {[p.shape[1] for p in parts]}")
    dev = parts[0].device
    datas, indices, ptrs, off = [], [], [torch.zeros(1, dtype=torch.int64,
                                                     device=dev)], 0
    for p in parts:
        ptr, k = _ptr(p), stored(p)
        datas.append(p.data[:k].to(torch.float32))
        indices.append(p.indices[:k].to(torch.int32))
        ptrs.append(ptr[1:] + off)
        off += k
    return CSRBatch(torch.cat(datas), torch.cat(indices), torch.cat(ptrs),
                    (sum(p.shape[0] for p in parts), d))


def shard_row_mask(n: int, n_shards: int) -> torch.Tensor:
    """[n_shards, rows_per_shard] bool: True on real rows, False on the
    padded tail ``shard_csr`` appends so every shard has equal rows."""
    rows = -(-n // n_shards)
    return torch.arange(n_shards * rows).reshape(n_shards, rows) < n


def pad_csr_capacity(pieces: list[CSRBatch], *, rows: int | None = None,
                     nnz_multiple: int = 1) -> list[CSRBatch]:
    """Give every piece ``rows`` rows (empty rows appended) and one
    stored-slot capacity, the largest piece's rounded up to
    ``nnz_multiple``; the slack past ``indptr[-1]`` holds zeros in column 0
    (capacity contract). Each stored value is copied once."""
    if not pieces:
        raise ValueError("need at least one piece")
    rows = max(p.shape[0] for p in pieces) if rows is None else int(rows)
    cap = max(stored(p) for p in pieces)
    cap = -(-cap // nnz_multiple) * nnz_multiple
    out = []
    for p in pieces:
        if p.shape[0] > rows:
            raise ValueError(f"piece has {p.shape[0]} rows > rows={rows}")
        ptr, k = _ptr(p), stored(p)
        ptr = torch.cat([ptr, ptr.new_full((rows - p.shape[0],), k)])
        data = torch.zeros(cap, dtype=torch.float32, device=p.device)
        data[:k] = p.data[:k]
        indices = torch.zeros(cap, dtype=torch.int32, device=p.device)
        indices[:k] = p.indices[:k]
        out.append(CSRBatch(data, indices, ptr, (rows, p.shape[1])))
    return out


def shard_csr(batch: CSRBatch, n_shards: int, *,
              nnz_multiple: int = 1) -> list[CSRBatch]:
    """Row-split ``batch`` into ``n_shards`` equal-shape shards: shard k
    owns rows [k*rows, (k+1)*rows), rows = ceil(n / n_shards), its indptr
    rebased to 0; short shards get empty rows (``shard_row_mask``) and
    every shard one stored-slot capacity. ``to_dense`` of shard k is the
    dense row block k zero-padded to ``rows`` rows."""
    if n_shards < 1:
        raise ValueError(f"need n_shards >= 1, got {n_shards}")
    n = batch.shape[0]
    rows = -(-n // n_shards)
    pieces = [slice_rows(batch, k * rows, min((k + 1) * rows, n))
              for k in range(n_shards)]
    return pad_csr_capacity(pieces, rows=rows, nnz_multiple=nnz_multiple)
