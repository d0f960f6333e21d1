"""SmolLM-360M — llama-arch small dense LM. [hf:HuggingFaceTB/SmolLM-360M]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_head=64,
    d_ff=2560, vocab_size=49152,
    rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_head=32,
    d_ff=256, vocab_size=512, tie_embeddings=True,
    attn_q_chunk=64, attn_kv_chunk=64,
)
