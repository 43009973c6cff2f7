"""qwen3-32b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=25600, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256)
