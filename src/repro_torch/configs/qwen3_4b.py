"""Qwen3-4B — dense, GQA kv=8, qk-norm, decoupled head_dim. [hf:Qwen/Qwen3-4B]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab_size=151936,
    rope_theta=1e6, qk_norm=True,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512, qk_norm=True,
    attn_q_chunk=64, attn_kv_chunk=64,
)
