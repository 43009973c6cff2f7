"""Mini-batch sampling strategies (paper §3.1, Fig.1b), the port of
``repro/data/sampling.py``.

* stride sampling — X^i = { x_{i + j*B} }: least within-batch correlation.
* block sampling  — X^i = { x_{i*N/B + j} }: streaming-friendly; over a
  live stream of ragged chunks it is ``stream_blocks``.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator

import numpy as np
import torch


def batch_indices(n: int, n_batches: int,
                  strategy: str = "stride") -> list[np.ndarray]:
    """Disjoint index sets for B mini-batches. Trailing remainder samples are
    folded into the last batch (the paper assumes N % B == 0)."""
    if n_batches < 1 or n_batches > n:
        raise ValueError(f"need 1 <= B <= N, got B={n_batches}, N={n}")
    if strategy == "stride":
        return [np.arange(i, n, n_batches) for i in range(n_batches)]
    if strategy == "block":
        size = n // n_batches
        out = [np.arange(i * size, (i + 1) * size) for i in range(n_batches)]
        if n % n_batches:
            out[-1] = np.arange((n_batches - 1) * size, n)
        return out
    raise ValueError(f"unknown sampling strategy {strategy!r}")


def split_batches(x: np.ndarray, n_batches: int,
                  strategy: str = "stride") -> list[np.ndarray]:
    return [x[idx] for idx in batch_indices(len(x), n_batches, strategy)]


def _chunk_slice(chunk, start: int, stop: int):
    """Row slice of a dense tensor (a view) or a CSRBatch (O(slice nnz))."""
    from .sparse import is_sparse, slice_rows
    if is_sparse(chunk):
        return slice_rows(chunk, start, stop)
    return chunk[start:stop]


def _chunk_cat(pieces: list):
    """Assemble one mini-batch from buffered pieces. A batch touched by any
    CSR piece comes out CSR (its dense pieces are sparsified: sparse rows
    are never densified). The pieces are views of chunks the re-chunker
    owns (copied on arrival), so a one-piece batch is returned as it is."""
    from .sparse import concat_csr, csr_from_dense, is_sparse
    if len(pieces) == 1:
        return pieces[0]
    if any(is_sparse(p) for p in pieces):
        return concat_csr([p if is_sparse(p) else csr_from_dense(p)
                           for p in pieces])
    return torch.cat(pieces, dim=0)


def _own(chunk):
    """A copy of a stream chunk that nothing else holds: a CPU tensor [k,
    d] or a CSRBatch of CPU tensors."""
    from .sparse import CSRBatch, as_csr, is_sparse
    if is_sparse(chunk):
        b = as_csr(chunk)
        return CSRBatch(*(t.to("cpu").clone() for t in b.tensors()),
                        b.shape)
    if torch.is_tensor(chunk):
        return torch.atleast_2d(chunk.detach().to("cpu").clone())
    return torch.from_numpy(np.array(np.atleast_2d(chunk)))


def stream_blocks(stream: Iterator, batch_size: int) -> Iterator:
    """Re-chunk a stream of rows into block mini-batches of ``batch_size``
    rows (the last one holds the remainder): §3.1's data-stream mode, where
    clustering starts at the first batch.

    Chunks may be dense [k, d] arrays or tensors, or CSR batches, of any
    ragged sizes; a batch with any CSR piece comes out CSR. The buffer
    keeps an offset into its head chunk instead of re-concatenating the
    tail at every batch. Each chunk is copied once, on arrival: chunks are
    held across later pulls, and producers reuse one read buffer
    (``buf[:] = ...; yield buf``), so a held view would be overwritten.
    After that copy slicing and one-piece batches are views."""
    if batch_size < 1:
        raise ValueError(f"need batch_size >= 1, got {batch_size}")
    buf: deque = deque()
    offset = 0                      # rows of buf[0] already consumed
    have = 0                        # unconsumed rows buffered

    def take(n_rows: int):
        nonlocal offset, have
        pieces, need = [], n_rows
        while need:
            head = buf[0]
            use = min(len(head) - offset, need)
            pieces.append(_chunk_slice(head, offset, offset + use))
            offset += use
            need -= use
            if offset == len(head):
                buf.popleft()
                offset = 0
        have -= n_rows
        return _chunk_cat(pieces)

    for chunk in stream:
        chunk = _own(chunk)
        if len(chunk) == 0:
            continue
        buf.append(chunk)
        have += len(chunk)
        while have >= batch_size:
            yield take(batch_size)
    if have:
        yield take(have)
