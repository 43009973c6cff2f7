"""grok-1-314b [moe] — 8 experts top-2, GQA kv=8, attention logit softcap.
[hf:xai-org/grok-1; unverified]"""
import dataclasses

from .base import ModelConfig

FULL = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32768, vocab_size=131072,
    n_experts=8, moe_top_k=2,
    attn_softcap=30.0, final_softcap=30.0, tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, n_experts=4, moe_top_k=2)
