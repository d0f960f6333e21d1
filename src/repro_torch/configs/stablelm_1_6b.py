"""StableLM-2-1.6B — MHA, partial rotary 25%, LayerNorm, qkv bias.
[hf:stabilityai/stablelm-2-1_6b]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=5632, vocab_size=100352,
    partial_rotary=0.25, norm="layernorm", qkv_bias=True, norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="stablelm-1.6b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, d_head=24,
    d_ff=256, vocab_size=512,
    partial_rotary=0.25, norm="layernorm", qkv_bias=True, norm_eps=1e-5,
    attn_q_chunk=64, attn_kv_chunk=64,
)
