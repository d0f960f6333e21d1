"""Config schema: model architecture and run settings.

Counterpart of ``repro.configs.base``: ``ModelConfig`` and
``ShapeConfig`` (a training run's batch and sequence length); the
reference's shape and mesh tables are not ported. All of the reference's fields are kept so configs compare
field by field.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.approx import ApproxConfig

EXACT = ApproxConfig()


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # query heads
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # attention flavor
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full causal
    mrope: bool = False
    mrope_sections: tuple = ()
    pos_emb: str = "rope"          # rope | sin
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    # SSM / hybrid
    ssm: str = ""
    ssm_state: int = 0
    ssm_head_dim: int = 64
    hybrid_period: int = 0
    hybrid_lora_rank: int = 0
    # modality stubs
    n_codebooks: int = 0
    vision_stub: bool = False
    # numerics / schedule
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True             # training: recompute each layer
    unroll_scans: bool = False     # the reference's analysis mode; unused
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    ssm_chunk: int = 64
    approx: ApproxConfig = EXACT
    sub_quadratic: bool = False

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def with_approx(self, approx: ApproxConfig) -> "ModelConfig":
        return replace(self, approx=approx)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

