"""Launcher of the CUDA kernel ``flash_attention``
(``csrc/flash_attention.cu``).

The port of ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:85``):
softmax(mask(softcap(q k^T dh^-1/2))) v with an online softmax whose state
stays f32 on chip, GQA by head index (K and V are never repeated in memory),
a top-left causal mask that skips key blocks wholly after the query block,
and the output in the tiles' dtype. One CTA owns 64 query rows of one
(batch, head) and loops over the key blocks; it masks keys past Sk and rows
past Sq itself. ``ops.flash_attention`` is the wrapper callers use; this
module only checks operands and launches.
"""
from __future__ import annotations

import torch

from . import build

#: head dims the kernel takes: multiples of DH_MULTIPLE up to DH_MAX
DH_MULTIPLE, DH_MAX = 16, 256
_ENTRY = {torch.float32: "rt_flash_attention_f32",
          torch.bfloat16: "rt_flash_attention_bf16"}


def check_head_dim(dh: int) -> None:
    if dh % DH_MULTIPLE or not DH_MULTIPLE <= dh <= DH_MAX:
        raise ValueError(f"flash_attention takes a head dim that is a "
                         f"multiple of {DH_MULTIPLE} up to {DH_MAX}, got {dh}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, softcap: float | None
                         ) -> torch.Tensor:
    """q [B, H, Sq, dh], k and v [B, KH, Sk, dh] in one dtype (f32 or bf16),
    contiguous, H a multiple of KH -> o [B, H, Sq, dh] in that dtype."""
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
    build.check_operand(q, "q", dtype=q.dtype, shape=(b, h, sq, dh),
                        device=dev)
    build.check_operand(k, "k", dtype=q.dtype, shape=(b, kh, sk, dh),
                        device=dev)
    build.check_operand(v, "v", dtype=q.dtype, shape=(b, kh, sk, dh),
                        device=dev)
    out = torch.empty_like(q)
    build.launch(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, h, kh, sq, sk, dh, int(causal),
                 float(dh ** -0.5), float(softcap or 0.0))
    return out
