"""zamba2-2.7b [hybrid] — Mamba2 backbone + ONE shared attention/MLP block
applied every 6 layers (weight sharing). ssm_state=64.
[arXiv:2411.15242; hf]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, conv_kernel=4, attn_period=6,
    shared_attn_window=4096, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
    d_ff=256, vocab_size=256, ssm_state=16, attn_period=2,
    shared_attn_window=16)
