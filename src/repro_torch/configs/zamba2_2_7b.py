"""Zamba2-2.7B — Mamba2 backbone + shared attention block (every 9th layer,
per-invocation LoRA rank 64; simplified from the released A/B alternation,
as the reference has it). ssm_state=64. [arXiv:2411.15242]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab_size=32000,
    ssm="mamba2", ssm_state=64, ssm_head_dim=64,
    hybrid_period=9, hybrid_lora_rank=64,
    act="gelu", sub_quadratic=True, ssm_chunk=128,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=512,
    ssm="mamba2", ssm_state=16, ssm_head_dim=16,
    hybrid_period=2, hybrid_lora_rank=8,
    act="gelu", sub_quadratic=True, ssm_chunk=16,
    attn_q_chunk=32, attn_kv_chunk=32,
)
