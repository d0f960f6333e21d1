"""Qwen2-VL-2B — M-RoPE (t,h,w), GQA kv=2; vision frontend is a stub
(precomputed patch embeddings merged at masked positions). [arXiv:2409.12191]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab_size=151936,
    mrope=True, mrope_sections=(16, 24, 24), vision_stub=True,
    rope_theta=1e6, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512,
    mrope=True, mrope_sections=(6, 5, 5), vision_stub=True, qkv_bias=True,
    attn_q_chunk=64, attn_kv_chunk=64,
)
