"""Mixtral-8x7B — MoE 8 experts top-2, SWA 4096 (=> sub-quadratic; long_500k
runs with a ring cache). [arXiv:2401.04088]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=32000,
    n_experts=8, n_experts_active=2, sliding_window=4096,
    rope_theta=1e6, sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=192, vocab_size=512,
    n_experts=4, n_experts_active=2, sliding_window=48, sub_quadratic=True,
    moe_capacity_factor=4.0,
    attn_q_chunk=32, attn_kv_chunk=32,
)
