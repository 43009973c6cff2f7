"""rwkv6-7b [ssm] — Finch: attn-free, data-dependent decay. 64 wkv heads of
64 channels. [arXiv:2404.05892; hf]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_head=64,
    d_ff=14336, vocab_size=65536,
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_head=64,
    d_ff=256, vocab_size=256)
