"""RWKV6 (Finch) 1.6B — attention-free, data-dependent decay; O(1) decode
state => long_500k runs. [arXiv:2404.05892]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=7168, vocab_size=65536,
    ssm="rwkv6", sub_quadratic=True, ssm_chunk=64,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=512,
    ssm="rwkv6", sub_quadratic=True, ssm_chunk=16,
)
