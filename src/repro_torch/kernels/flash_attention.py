"""Launcher of the CUDA kernel ``flash_attention``
(``csrc/flash_attention.cu``).

The port of ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:85``):
softmax(mask(softcap(q k^T dh^-1/2))) v with an online softmax whose state
stays f32 on chip, GQA by head index (K and V are never repeated in memory),
a top-left causal mask that skips key blocks wholly after the query block,
and the output in the tiles' dtype. The kernel masks keys past Sk and rows
past Sq itself. Two bodies: f32 tiles in 3xTF32 on mma.sync with a
cp.async ring, and bf16 tiles on wgmma with TMA loads; both read q, k and v
through their strides and write o through its own. ``ops.flash_attention``
is the wrapper callers use; this module only checks operands and launches.
"""
from __future__ import annotations

import torch

from . import build

#: head dims the kernel takes: multiples of DH_MULTIPLE up to DH_MAX
DH_MULTIPLE, DH_MAX = 16, 256
_ENTRY = {torch.float32: "rt_flash_attention_f32",
          torch.bfloat16: "rt_flash_attention_bf16"}
#: the bf16 body's TMA reads: 16-byte aligned base and strides
_ALIGN = 16


def check_head_dim(dh: int) -> None:
    if dh % DH_MULTIPLE or not DH_MULTIPLE <= dh <= DH_MAX:
        raise ValueError(f"flash_attention takes a head dim that is a "
                         f"multiple of {DH_MULTIPLE} up to {DH_MAX}, got {dh}")


def tma_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """The (batch, head, row) element strides by which either body reads a
    [B, heads, S, dh] tensor in place (the bf16 body's TMA maps, the f32
    body's 16-byte cp.async copies), or None where it cannot: dh must be
    contiguous, and the base and every stride 16-byte aligned. A stride of
    a dimension of size 1 is never used; it is replaced by the tensor's
    span, which is valid whatever torch reports for it."""
    st, sh = t.stride(), t.shape
    if len(st) != 4 or st[3] != 1 or t.data_ptr() % _ALIGN:
        return None
    unit = _ALIGN // t.element_size()
    span = max(st[0] * sh[0], st[1] * sh[1], st[2] * sh[2], sh[3])
    span = -(-span // unit) * unit
    out = tuple(span if sh[d] == 1 else st[d] for d in range(3))
    return None if any(s <= 0 or s % unit for s in out) else out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, softcap: float | None
                         ) -> torch.Tensor:
    """q [B, H, Sq, dh], k and v [B, KH, Sk, dh] in one dtype (f32 or bf16),
    H a multiple of KH -> o [B, H, Sq, dh] in that dtype. The operands are
    read in place through their strides where ``tma_strides`` allows (a view
    it refuses is copied once, contiguous), and o is a [B, H, Sq, dh] view
    of [B, Sq, H, dh] memory."""
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes f32 or bf16 tiles, "
                        f"got {q.dtype}")
    b, h, sq, dh = q.shape
    kh, sk = k.shape[1], k.shape[2]
    check_head_dim(dh)
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if sq == 0 or sk == 0:
        raise ValueError(f"flash_attention needs Sq, Sk > 0, got {sq}, {sk}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    dev = q.device
    shapes = {"q": (q, (b, h, sq, dh)), "k": (k, (b, kh, sk, dh)),
              "v": (v, (b, kh, sk, dh))}
    strides, operands = [], []
    for name, (t, shape) in shapes.items():
        if t.device != dev or t.dtype != q.dtype or t.shape != shape:
            raise ValueError(f"{name} must be {q.dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        st = tma_strides(t)
        if st is None:   # a view the kernel cannot read: one contiguous copy
            t = t.clone(memory_format=torch.contiguous_format)
            st = tma_strides(t)
        operands.append(t)
        strides += st
    q, k, v = operands
    # o [B, H, Sq, dh] as a view of [B, Sq, H, dh] memory
    out_strides = (sq * h * dh, dh, h * dh)
    out = torch.empty_strided((b, h, sq, dh), out_strides + (1,),
                              dtype=q.dtype, device=dev)
    strides += out_strides
    build.launch(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, h, kh, sq, sk, dh, int(causal),
                 float(dh ** -0.5), float(softcap or 0.0), *strides)
    return out
