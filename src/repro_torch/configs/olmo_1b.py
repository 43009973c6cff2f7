"""olmo-1b [dense] — non-parametric LN (no affine), MHA (kv == heads), tied.
[arXiv:2402.00838; hf]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=8192, vocab_size=50304,
    parametric_norm=False, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=256)
