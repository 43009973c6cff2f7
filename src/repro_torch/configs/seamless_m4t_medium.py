"""seamless-m4t-medium [audio] — enc-dec, multimodal; speech frontend is a
STUB (input_specs provides precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=24, n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab_size=256206,
    tie_embeddings=True, modality="audio_stub", frontend_dim=1024,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=4, n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256, frontend_dim=64)
