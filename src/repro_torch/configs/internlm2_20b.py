"""internlm2-20b [dense] — GQA. [arXiv:2403.17297; hf]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab_size=92544,
    rope_theta=1e6, tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256)
