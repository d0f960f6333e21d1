"""The port stands alone: no module of ``repro_torch`` (``apps/`` included)
nor ``chip_smoke.py`` imports ``jax``, ``ml_dtypes``, anything of ``repro``
or the reference's ``benchmarks``; importing the package needs no
compiler and no GPU; and entry points asked for ``device='cuda'`` on a host
without one raise instead of carrying on on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax", "ml_dtypes",
             "benchmarks")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
    text = path.read_text()
    for word in ("torch.compile", "scaled_dot_product_attention"):
        if path.name != "chip_smoke.py":
            assert word not in text, f"{path.name} mentions {word}"


def test_every_package_module_is_covered():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES[:-1]}
    for needed in ("core/mitchell.py", "core/error_lut.py", "core/simdive.py",
                   "core/device.py",
                   "core/approx.py", "kernels/datapath.py",
                   "core/simd_pack.py",
                   "kernels/build.py", "kernels/elemwise.py",
                   "kernels/logmatmul.py", "kernels/packed_simd.py",
                   "kernels/flash_attention.py", "kernels/registry.py",
                   "kernels/decode_attention.py",
                   "kernels/ops.py", "configs/base.py",
                   "configs/smollm_360m.py", "models/layers.py",
                   "models/transformer.py", "models/model.py",
                   "models/convert.py", "launch/serve.py",
                   "metrics/timing.py", "metrics/errors.py",
                   "metrics/operands.py", "metrics/trajectory.py",
                   "tuning/frontier.py", "tuning/select.py",
                   "faults/inject.py", "faults/scrub.py",
                   "faults/campaign.py", "launch/scheduler.py",
                   "core/lod.py", "core/baselines.py", "metrics/image.py",
                   "models/ssm.py", "configs/rwkv6_1_6b.py",
                   "configs/zamba2_2_7b.py", "models/loss.py",
                   "core/tree.py", "optim/optimizers.py",
                   "optim/grad_compress.py", "data/pipeline.py",
                   "checkpoint/checkpoint.py", "metrics/divergence.py",
                   "tuning/sensitivity.py", "train/schedule.py",
                   "train/loop.py", "launch/train.py",
                   "apps/__init__.py", "apps/table4_ann.py",
                   "apps/fig34_imaging.py", "launch/sharding.py",
                   "launch/mesh.py", "launch/specs.py"):
        assert needed in names, needed
    csrc = {p.name for p in (PKG / "kernels" / "csrc").iterdir()}
    assert {"simdive_datapath.cuh", "elemwise.cu", "decode_attention.cu",
            "flash_attention.cu", "logmatmul.cu", "packed_simd.cu"} <= csrc


def test_launch_counts_name_every_schedule():
    """One count per kernel schedule: both attention schedules beside the
    elemwise, the packed and the two matmul ones, and one for each
    width-32 form."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.packed_simd import packed_cuda

    packed_cuda.launches = 3
    reset_launch_counts()
    assert packed_cuda.launches == 0
    assert launch_counts() == {"attention": 0, "attention_pipelined": 0,
                               "attention_pipelined_w32": 0,
                               "attention_w32": 0, "decode_attention": 0,
                               "decode_attention_w32": 0, "elemwise": 0,
                               "elemwise_w32": 0, "matmul": 0,
                               "matmul_pipelined": 0, "packed": 0,
                               "sqrt": 0, "sqrt_w32": 0}


def test_ring_kernels_share_the_cp_async_header():
    """Both ring schedules include one cp.async header; neither keeps a
    copy of its helpers."""
    csrc = PKG / "kernels" / "csrc"
    header = (csrc / "cp_async.cuh").read_text()
    for helper in ("cp_async4", "cp_async_commit", "cp_async_wait"):
        assert f"void {helper}(" in header
    for name in ("logmatmul.cu", "flash_attention.cu"):
        text = (csrc / name).read_text()
        assert '#include "cp_async.cuh"' in text, name
        assert "asm volatile(\"cp.async" not in text, name


def _run(code: str, **env):
    full_env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **env}
    return subprocess.run([sys.executable, "-c", code], env=full_env,
                          capture_output=True, text=True, timeout=300)


def test_importing_every_module_pulls_in_no_jax_and_builds_nothing():
    mods = [".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("")
                     .parts).removesuffix(".__init__") for p in SOURCES[:-1]]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.kernels as k\n"
        "k.get_op; k.simdive_attention\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} or m.split('.')[0] == 'triton')\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import build\n"
        "assert build._lib is None, 'an import built or loaded the kernels'\n"
        "print('clean', len(sys.modules))\n")
    done = _run(code, PATH="/nonexistent")  # no nvcc reachable, none needed
    assert done.returncode == 0, done.stderr
    assert "clean" in done.stdout


def test_kernel_build_without_nvcc_raises_a_clear_error(tmp_path):
    code = (
        "from pathlib import Path\n"
        "from repro_torch.kernels import build\n"
        f"build.build_dir = lambda: Path({str(tmp_path / 'build')!r})\n"
        "try:\n"
        "    build.load()\n"
        "except build.KernelCompileError as e:\n"
        "    print('raised:', e)\n")
    done = _run(code, PATH="/nonexistent",
                CUDA_HOME=str(tmp_path / "no_cuda"))
    assert done.returncode == 0, done.stderr
    assert "raised: nvcc not found" in done.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the behaviour of a host without a GPU")
def test_cuda_entry_points_raise_without_a_gpu():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build

    cfg = get_config("smollm-360m", smoke=True)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build(cfg)                                   # device defaults to cuda
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--arch", "smollm-360m", "--smoke"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--arch", "smollm-360m", "--smoke", "--approx", "simdive",
                    "--emulate", "--quantize"])
    lm = build(cfg, device="cpu")
    assert lm.device.type == "cpu"
    # a kernel wrapper handed CPU tensors raises instead of computing
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels.logmatmul import logmatmul_cuda

    x = torch.ones(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        logmatmul_cuda(x, x.T.contiguous(), SimdiveSpec())
    # the packed op asked for its kernel, and the error sweep, which runs on
    # the card by default, raise instead of computing on the CPU
    from repro_torch.kernels import simdive_packed
    from repro_torch.tuning import measure_error

    words = torch.ones(2, 4, dtype=torch.uint32)
    with pytest.raises(ValueError, match="backend 'cuda'"):
        simdive_packed(words, words, SimdiveSpec(), backend="cuda")
    for kernel in ("packed", "elemwise"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            measure_error("mul", 8, 6, kernel=kernel)


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert done.returncode != 0
    assert '"ok"' not in done.stdout
