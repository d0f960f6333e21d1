"""MusicGen-medium — decoder-only over 4 EnCodec codebooks (vocab 2048 each);
modality frontend is a stub (precomputed frame embeddings). [arXiv:2306.05284]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_head=64,
    d_ff=6144, vocab_size=2048,
    n_codebooks=4, norm="layernorm", act="gelu", pos_emb="sin", norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke", family="audio",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, d_head=24,
    d_ff=256, vocab_size=128,
    n_codebooks=4, norm="layernorm", act="gelu", pos_emb="sin", norm_eps=1e-5,
    attn_q_chunk=64, attn_kv_chunk=64,
)
