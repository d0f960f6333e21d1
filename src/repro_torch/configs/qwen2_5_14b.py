"""Qwen2.5-14B — dense, GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-14B]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=13824, vocab_size=152064,
    rope_theta=1e6, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512, qkv_bias=True,
    attn_q_chunk=64, attn_kv_chunk=64,
)
