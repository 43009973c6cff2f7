"""Launcher of the CUDA kernel ``sketch_assign`` (``csrc/sketch_assign.cu``).

The port of ``sketch_assign_pallas`` (``repro/kernels/sketch_assign.py:111``):
count-sketch each row, z_j = sum_{i: h_i = j} sign_i x_i, contract z with
the value panel V on chip and take min_j (csq_j - 2 (z V)_ij) and its
argmin. The TPU body built a masked one-hot tile for its matrix unit; the
CUDA kernel gathers each bucket's columns instead, from the bucket-sorted
tables of ``bucket_tables`` (built once per map), in a fixed order, so two
launches agree bitwise, and contracts on the tensor cores in 3xTF32.
``geometry`` sizes its bucket chunk and its persistent grid from the
shared memory a CTA needs, and says whether the gather program is staged
in shared memory or read in place (the source's header says how it is
laid out); rows of any width launch.
``ops.sketch_assign`` is the wrapper callers use; this module builds the
tables, checks operands, sizes the launch and launches.
"""
from __future__ import annotations

import functools

import torch

from . import build
from .assign import CP_MULTIPLE, MAX_CP
from .kernel_matrix import _sm_count

#: csrc/sketch_assign.cu: rows a block, bytes of a staged row a ring stage
#: holds (plus 16 of padding), ring stages, the zT row pitch (floats), the
#: argmin's per-row slots and the warps (bucket j belongs to warp j mod 8)
ROWS, ROW_BYTES, NSTAGE, ZP, NG, WARPS = 32, 512, 3, 40, 4, 8
#: the entry flags of the gather program (``gather_program``)
FIRST, LAST = 1 << 30, 1 << 29
#: the most shared memory a block may use, and an SM holds (each block
#: also reserves 1 KB)
SMEM_BLOCK, SMEM_SM = 232448, 233472

_ENTRY = {torch.float32: "rt_sketch_assign_f32",
          torch.bfloat16: "rt_sketch_assign_bf16"}


def bucket_tables(h: torch.Tensor, sign: torch.Tensor, m: int):
    """Sort the input columns by bucket: (order [D] int32, offsets [m + 1]
    int32, sign [D] f32 in that order). Bucket j owns the columns
    ``order[offsets[j]:offsets[j + 1]]``, in increasing index order (the
    sort is stable); columns with h = -1 sort before ``offsets[0]``."""
    hs, order = torch.sort(h.to(torch.int64), stable=True)
    offsets = torch.searchsorted(
        hs, torch.arange(m + 1, dtype=torch.int64, device=h.device))
    return (order.to(torch.int32).contiguous(),
            offsets.to(torch.int32).contiguous(),
            sign.to(torch.float32)[order].contiguous())


def sign_matrix(h: torch.Tensor, sign: torch.Tensor, m: int) -> torch.Tensor:
    """The count sketch as a [D, m] f32 matrix: row i holds sign_i in column
    h_i, and no entry where h_i = -1, so that z = x @ S."""
    d = h.shape[0]
    s = torch.zeros((d, m + 1), dtype=torch.float32, device=h.device)
    s[torch.arange(d, device=h.device), h.long() % (m + 1)] = \
        sign.to(torch.float32)                    # h = -1 -> column m, dropped
    return s[:, :m].contiguous()


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def chunk_features(itemsize: int) -> int:
    """Features of a row one ring stage holds (KD)."""
    return ROW_BYTES // itemsize


def mpos(m: int) -> int:
    """The row of ``gather_program``'s positions: m rounded up to the
    warps, and one more group for the groups' ends."""
    return _up(m, WARPS) + WARPS


def smem_bytes(e: int, nch: int, m: int, cp: int, mb: int, *,
               staged: bool = True) -> int:
    """Shared memory of the kernel (``sk::smem_bytes``) for a program of e
    entries over nch column chunks, m buckets, Cp clusters and bucket
    chunks of mb: the ring, zT [mb][ZP], V [mb][pitch 8 mod 32], where the
    program is ``staged`` the program and its positions, and the argmin
    slots."""
    vp = _up(cp, 32) + 8
    program = 8 * _up(e, 2) + 4 * _up(nch * mpos(m), 4) if staged else 0
    return (NSTAGE * ROWS * (ROW_BYTES + 16) + 4 * (mb * ZP + mb * vp)
            + program + 8 * ROWS * NG)


def _fit(d: int, m: int, cp: int, itemsize: int, staged: bool):
    """(mb, ctas per SM) for a program of d entries, staged or read in
    place, or None where not even 8 buckets fit beside a staged one."""
    nch = -(-d // chunk_features(itemsize))

    def need(mb):
        return smem_bytes(d, nch, m, cp, mb, staged=staged)
    mb = _up(m, 8)
    if 2 * (need(mb) + 1024) <= SMEM_SM:
        return mb, 2
    if need(mb) <= SMEM_BLOCK:
        return mb, 1
    per = (need(8) - need(0)) // 8
    mb = (SMEM_BLOCK - need(0)) // per // 8 * 8
    return (mb, 1) if mb >= 8 else None


@functools.lru_cache(maxsize=256)
def geometry(d: int, m: int, cp: int, itemsize: int) -> tuple[int, int,
                                                               bool]:
    """(mb, ctas per SM, staged): the buckets of a chunk, the CTAs an SM
    holds and where the gather program lies, for rows of d features of
    ``itemsize`` bytes (a program of at most d entries). All m buckets in
    one chunk (X read once, V loaded once per CTA) at two CTAs per SM where
    they fit, else at one; else the widest chunk that fits one CTA (each
    chunk re-reads X). The program is read in place from global memory, so
    every width launches; it is staged in shared memory only where that
    leaves the chunk and the CTAs an SM holds as they are (a narrow
    program: Tab.2's dense view, which read in place ran 5% slower)."""
    in_place = _fit(d, m, cp, itemsize, staged=False)
    if in_place is None:
        raise ValueError(f"sketch_assign: Cp={cp} leaves no room for a "
                         f"bucket chunk in {SMEM_BLOCK} bytes of shared "
                         f"memory")
    staged = _fit(d, m, cp, itemsize, staged=True)
    return (*in_place, staged == in_place)


def gather_program(order: torch.Tensor, offsets: torch.Tensor,
                   sign: torch.Tensor, m: int, kd: int):
    """The kernel's gather program for the tables of ``bucket_tables`` and
    column chunks of kd features: (program [E, 2] int32, positions [nch,
    mpos(m)] int32), E the columns with h >= 0.

    The entries are sorted by (chunk c, warp w = bucket mod 8, bucket,
    column); entry k is {column - c kd, with the top bit set where its sign
    is negative; bucket | FIRST | LAST}, FIRST and LAST marking the first
    and last entry of its bucket within its chunk. positions[c][j] is the
    index of the first entry of group (c, j mod 8) whose bucket is >= j, so
    a warp's entries for buckets [jb, je) of chunk c are the run
    positions[c][jb + w] .. positions[c][je + w]. Each bucket keeps its
    columns in increasing order, so the kernel sums z in the order of the
    parent kernel's gather."""
    dev = order.device
    lo, hi = (int(v) for v in offsets[[0, m]].tolist())
    k = torch.arange(lo, hi, device=dev)
    j = torch.searchsorted(offsets[1:m + 1].to(torch.int64), k, right=True)
    col = order[lo:hi].to(torch.int64)
    c = col // kd
    mp = mpos(m)
    key = (c * WARPS + j % WARPS) * mp + j
    key, perm = torch.sort(key, stable=True)
    j, col, c = j[perm], col[perm], c[perm]
    neg = (sign[lo:hi][perm] < 0).to(torch.int64)
    edge = key[1:] != key[:-1]
    true = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([true, edge]).to(torch.int64)
    last = torch.cat([edge, true]).to(torch.int64)
    ex = (col - c * kd) | (neg << 31)
    ey = j | (first * FIRST) | (last * LAST)
    program = torch.stack([ex, ey], dim=1)
    program = (program - (program >= 2 ** 31).to(torch.int64) * 2 ** 32).to(
        torch.int32).contiguous()
    nch = -(-order.shape[0] // kd)
    cc = torch.arange(nch, device=dev)[:, None]
    jj = torch.arange(mp, device=dev)[None, :]
    want = ((cc * WARPS + jj % WARPS) * mp + jj).reshape(-1)
    positions = torch.searchsorted(key, want).to(torch.int32).reshape(
        nch, mp).contiguous()
    return program, positions


def grid(n: int, sms: int, ctas_per_sm: int) -> int:
    """The persistent grid: a CTA per slot of the card, no more than the
    row blocks of ROWS rows."""
    return max(1, min(-(-n // ROWS), sms * ctas_per_sm))


def sketch_assign_cuda(x: torch.Tensor, order: torch.Tensor,
                       offsets: torch.Tensor, sign: torch.Tensor,
                       v: torch.Tensor, csq: torch.Tensor, *,
                       programs: dict):
    """x [n, Dp] f32 or bf16, Dp >= D a multiple of the 16-byte vector (the
    columns past D are never read); order [D], offsets [M + 1] int32 and
    sign [D] f32 from ``bucket_tables`` (f32 signs at either dtype: they
    only build the gather program); v [M, Cp], csq [Cp] f32, Cp a multiple
    of ``CP_MULTIPLE`` and at most ``MAX_CP``; programs: the gather
    programs of these tables by chunk width, filled as launches need them
    (``CountSketchMap.programs``). Returns
    (labels [n] int32, score [n] f32)."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"sketch_assign takes f32 or bf16 rows, got {x.dtype}")
    entry = _ENTRY[x.dtype]
    n, dp = x.shape
    d = order.shape[0]
    m, cp = v.shape
    if not d <= dp < d + 16 or dp % (16 // x.element_size()):
        raise ValueError(f"x has {dp} columns for tables of {d}: pad D to "
                         f"a multiple of {16 // x.element_size()}")
    if cp % CP_MULTIPLE or not 0 < cp <= MAX_CP:
        raise ValueError(
            f"Cp={cp} must be a positive multiple of {CP_MULTIPLE} and at "
            f"most {MAX_CP} (the on-chip F accumulator holds {MAX_CP} "
            f"clusters; ops.sketch_assign launches once per {MAX_CP})")
    dev = x.device
    build.check_operand(x, "x", dtype=x.dtype, shape=(n, dp), device=dev)
    build.check_operand(order, "order", dtype=torch.int32, shape=(d,),
                        device=dev)
    build.check_operand(offsets, "offsets", dtype=torch.int32, shape=(m + 1,),
                        device=dev)
    build.check_operand(sign, "sign", dtype=torch.float32, shape=(d,),
                        device=dev)
    build.check_operand(v, "v", dtype=torch.float32, shape=(m, cp), device=dev)
    build.check_operand(csq, "csq", dtype=torch.float32, shape=(cp,), device=dev)
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    score = torch.empty((n,), dtype=torch.float32, device=dev)
    mb, per_sm, staged = geometry(d, m, cp, x.element_size())
    kd = chunk_features(x.element_size())
    if kd not in programs:
        programs[kd] = gather_program(order, offsets, sign, m, kd)
    program, positions = programs[kd]
    build.launch(entry, x.data_ptr(), program.data_ptr(),
                 positions.data_ptr(), v.data_ptr(), csq.data_ptr(),
                 labels.data_ptr(), score.data_ptr(), n, program.shape[0],
                 dp, m, cp, mb, grid(n, _sm_count(dev.index), per_sm),
                 int(staged))
    return labels, score
