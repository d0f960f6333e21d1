"""repro_torch.core — SIMDive arithmetic: Mitchell log datapath, correction
tables, specs, the segmented leading-one detector, sub-word SIMD packing,
and the model-facing approximate math (divider softmax, log-domain
rsqrt). The paper's baselines are in :mod:`repro_torch.core.baselines`."""
from .mitchell import (
    SUPPORTED_WIDTHS,
    frac_bits,
    lane_max_float,
    leading_one,
    mitchell_div,
    mitchell_log,
    mitchell_mul,
)
from .error_lut import build_table, build_table_clean, region_index
from .lod import nibble_lod, segmented_leading_one
from .simdive import SimdiveSpec, simdive_div, simdive_mul, simdive_sqrt
from .simd_pack import (
    lanes_per_word,
    pack,
    packed_div,
    packed_mixed,
    packed_mul,
    unpack,
)
from .approx import (
    ApproxConfig,
    approx_matmul,
    approx_rmsnorm,
    approx_softmax,
    attention_div,
    layer_label,
    quantize_sign_magnitude,
    serving_segments,
)

__all__ = [
    "SUPPORTED_WIDTHS", "frac_bits", "lane_max_float", "leading_one",
    "mitchell_div", "mitchell_log", "mitchell_mul",
    "build_table", "build_table_clean", "region_index",
    "nibble_lod", "segmented_leading_one",
    "SimdiveSpec", "simdive_div", "simdive_mul", "simdive_sqrt",
    "lanes_per_word", "pack", "packed_div", "packed_mixed", "packed_mul",
    "unpack",
    "ApproxConfig", "approx_matmul", "approx_rmsnorm", "approx_softmax",
    "attention_div", "layer_label", "quantize_sign_magnitude",
    "serving_segments",
]
