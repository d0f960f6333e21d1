"""repro_torch.core — SIMDive arithmetic: Mitchell log datapath, correction
tables, specs, sub-word SIMD packing, and the model-facing approximate
math."""
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
from .simdive import SimdiveSpec, simdive_div, simdive_mul
from .simd_pack import (
    lanes_per_word,
    pack,
    packed_div,
    packed_mixed,
    packed_mul,
    unpack,
)
from .approx import ApproxConfig, attention_div, layer_label, serving_segments

__all__ = [
    "SUPPORTED_WIDTHS", "frac_bits", "lane_max_float", "leading_one",
    "mitchell_div", "mitchell_log", "mitchell_mul",
    "build_table", "build_table_clean", "region_index",
    "SimdiveSpec", "simdive_div", "simdive_mul",
    "lanes_per_word", "pack", "packed_div", "packed_mixed", "packed_mul",
    "unpack",
    "ApproxConfig", "attention_div", "layer_label", "serving_segments",
]
