"""Llama-4-Scout-17B-16E — MoE 16 routed experts top-1 + 1 shared expert.
Chunked-attention/NoPE detail not modeled (global RoPE GQA), as in the
reference. [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, n_experts_active=1, n_shared_experts=1,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=192, vocab_size=512,
    n_experts=4, n_experts_active=1, n_shared_experts=1,
    moe_capacity_factor=4.0,
    attn_q_chunk=64, attn_kv_chunk=64,
)
