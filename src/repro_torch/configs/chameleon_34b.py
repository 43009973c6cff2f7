"""chameleon-34b [vlm] — early-fusion, VQ image tokens (the image tokenizer is
a stub: VQ codes are ordinary ids in the 65536 vocab), qk-norm.
[arXiv:2405.09818; unverified]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, tie_embeddings=False, modality="vlm_stub",
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256)
