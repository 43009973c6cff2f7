"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, GQA kv=4, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab_size=151936,
    n_experts=128, moe_top_k=8,
    qk_norm=True, rope_theta=1e6, tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, vocab_size=256, n_experts=4, moe_top_k=2)
