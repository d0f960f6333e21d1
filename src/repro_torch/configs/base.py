"""Config schema: model architecture and run settings.

Counterpart of ``repro.configs.base``: ``ModelConfig``, ``ShapeConfig``
(a run's batch and sequence length), the reference's shape table
(``SHAPES``, :func:`shapes_for`) and its production meshes as metadata
(``MeshConfig``, ``SINGLE_POD``, ``MULTI_POD``). All of the reference's
fields are kept so configs compare field by field.
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



SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: tuple = (16, 16)
    axes: tuple = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


def shapes_for(cfg: ModelConfig):
    """The assigned shape set for an arch (skips long_500k when quadratic)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return [SHAPES[n] for n in names]
