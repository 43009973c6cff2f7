"""gemma2-2b [dense] — local+global alternating, logit softcap, sandwich
norms, (1+w) RMSNorm, tied embeddings. [arXiv:2408.00118; hf]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=9216, vocab_size=256000,
    window=4096, local_global_period=2,
    attn_softcap=50.0, final_softcap=30.0,
    sandwich_norm=True, gemma_plus_one=True, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, window=8)
