"""Config schema: model architecture and input shapes.

A copy of ``repro/configs/base.py`` as data (``ModelConfig``,
``ShapeConfig``, ``TrainConfig`` and the dry run's ``SHAPES``). ``attn_impl="flash"`` selects the
hand-written CUDA kernel (``kernels/csrc/flash_attention.cu``) on the card
and its plain PyTorch version on the CPU; like the reference's kernel it
has no gradient, so training runs ``attn_impl="chunked"``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | encdec | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # attention flavour
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    window: int | None = None          # sliding-window size for local layers
    local_global_period: int = 0       # gemma2: 2 -> [local, global] alternate
    sandwich_norm: bool = False        # gemma2 post-norms
    parametric_norm: bool = True       # olmo: False (non-parametric LN)
    gemma_plus_one: bool = False       # (1+w) RMSNorm parameterization
    rope_theta: float = 1e4
    tie_embeddings: bool = True
    q_chunk: int = 512              # chunked-attention query-block size
    attn_impl: str = "chunked"      # "chunked" (plain PyTorch) | "flash"
                                    # (CUDA kernel; plain version on CPU)
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # expert parallelism: 0 -> one global capacity buffer; > 0 ->
    # grouped dispatch with experts sharded over the data axis
    moe_ep_groups: int = 0
    # ssm / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_period: int = 0               # zamba2: shared attn every N layers
    shared_attn_window: int = 4096     # zamba2 long-context adaptation
    # encoder-decoder
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # modality stubs ([audio]/[vlm]: precomputed frontend embeddings)
    modality: str = "text"             # text | audio_stub | vlm_stub
    frontend_dim: int = 0              # stub embedding dim (== d_model)

    @property
    def gqa_groups(self) -> int:
        return self.n_heads // self.n_kv_heads


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    opt_state_dtype: str = "float32"   # "bfloat16" for the 314B config
    remat: bool = True
    microbatches: int = 1


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
