"""Builds and loads the hand-written CUDA kernels under ``csrc/``.

Nothing here runs at import: :func:`load` compiles at the first kernel
launch, so importing the package needs neither ``nvcc`` nor a GPU.

The build: every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together (``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-Xcompiler -fPIC -c``), then the objects are linked into one shared library
with a plain C interface and loaded with ``ctypes``. The sources include
none of PyTorch's headers, which keeps a build at seconds. The library
lands in ``<repo root>/build/repro_torch_kernels/<hash>/``, named by the content hash of every file in
``csrc/`` plus the flags, so an edited source rebuilds and an unchanged one
is reused. A failed build raises :class:`KernelCompileError` with the
compiler's output; nothing falls back to the plain versions.

Each C entry launches on the stream it is given, returns
``cudaGetLastError()`` and never synchronises; :func:`check` turns a
non-zero code into an exception.

**The fault register.** Every kernel reads the armed lane faults
(:mod:`repro_torch.faults.inject`) from ``simdive::g_fault_register``, a
``__constant__`` defined in ``csrc/simdive_datapath.cuh``. Each source is
compiled on its own (``-c``, no relocatable device code), so each holds
its own copy, and each exports a setter, ``simdive_faults_<source
stem>``. :func:`write_fault_register` calls every setter on the current
stream of every device the library has launched on (``load(device)``
records them), and a device seen for the first time while faults are
armed gets the register before its first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KernelCompileError", "KernelLaunchError", "CSRC", "NVCC_FLAGS",
           "build_dir", "load", "check", "current_stream",
           "write_fault_register"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
_LIB_NAME = "libsimdive_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# CUDA device indices whose copies of the fault register the library owns
_devices: set[int] = set()


class KernelCompileError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error code."""


def build_dir() -> Path:
    """Root of the build tree (listed in ``.gitignore``)."""
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise KernelCompileError(
            "nvcc not found (looked on PATH and under $CUDA_HOME / "
            "/usr/local/cuda): the CUDA kernels cannot be built on this host")
    return exe


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:        # one compiler per source, all in flight at once
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / f"build.{tag}.log").write_text("\n".join(log))
    if failed:
        raise KernelCompileError(
            f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
    tmp = out_dir / f"{_LIB_NAME}.{tag}"
    link = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _, _ in procs]]
    done = subprocess.run(link, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise KernelCompileError(f"link failed:\n{done.stdout}")
    lib = out_dir / _LIB_NAME
    os.replace(tmp, lib)       # atomic: a concurrent build sees old or new
    for _, obj, _, _ in procs:
        obj.unlink(missing_ok=True)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.simdive_elemwise.argtypes = [p, p, p, p, ll, p, i, i, i, i, i, i, i, p]
    lib.simdive_elemwise.restype = i
    lib.simdive_sqrt.argtypes = [p, p, ll, i, i, p]
    lib.simdive_sqrt.restype = i
    lib.simdive_packed.argtypes = [p, p, p, p, ll, p, i, i, i, i, i, i, i, p]
    lib.simdive_packed.restype = i
    lib.simdive_flash_attention.argtypes = (
        [p] * 5 + [i] * 12 + [f] + [i] * 4 + [f, p])
    lib.simdive_flash_attention.restype = i
    lib.simdive_flash_attention_pipelined.argtypes = (
        [p] * 5 + [i] * 12 + [f] + [i] * 4 + [f, i, p])
    lib.simdive_flash_attention_pipelined.restype = i
    lib.simdive_softmax_div.argtypes = [p, p, p, p, i, i, p, i, i, i, i, i,
                                        f, p]
    lib.simdive_softmax_div.restype = i
    lib.simdive_decode_attention.argtypes = (
        [p] * 7 + [i] * 8 + [ll, p, i, ll] * 2 + [i] * 3 + [f] + [i] * 4
        + [f, p])
    lib.simdive_decode_attention.restype = i
    lib.simdive_decode_attention_max_clusters.argtypes = [i] * 5
    lib.simdive_decode_attention_max_clusters.restype = i
    lib.simdive_logmatmul.argtypes = [p] * 3 + [i] * 3 + [p] + [i] * 10 + [p]
    lib.simdive_logmatmul.restype = i
    for name in _fault_setters():
        setter = getattr(lib, name)
        setter.argtypes = [p, p]
        setter.restype = i


def _fault_setters() -> list[str]:
    """One fault-register setter per source: ``simdive_faults_<stem>``."""
    return [f"simdive_faults_{src.stem}" for src in sorted(CSRC.glob("*.cu"))]


def load(device=None) -> ctypes.CDLL:
    """The kernels' shared library, built on first use.

    ``device`` (a CUDA ``torch.device``, given by every launcher) is the
    device the caller is about to launch on: the first time a device is
    seen while lane faults are armed, the register is written there, so
    that a kernel built or first launched after an arming starts from
    it."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = build_dir() / "repro_torch_kernels" / _sources_hash()
            path = out_dir / _LIB_NAME
            if not path.exists():
                path = _build(out_dir)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        if device is not None:
            index = device.index
            if index is None:
                import torch

                index = torch.cuda.current_device()
            if index not in _devices:
                _devices.add(index)
                # a register never written reads zero: disarmed
                if _armed_lanes():
                    _write_register(_lib, index)
        return _lib


def _armed_lanes() -> bool:
    from repro_torch.faults.inject import active_faults

    return any(s.site != "table" for s in active_faults())


def _write_register(lib: ctypes.CDLL, index: int) -> None:
    import numpy as np
    import torch

    from repro_torch.faults.inject import lane_register

    reg = np.ascontiguousarray(lane_register())
    with torch.cuda.device(index):
        stream = current_stream()
        for name in _fault_setters():
            check(getattr(lib, name)(reg.ctypes.data, stream), name)


def write_fault_register() -> None:
    """Write the armed lane faults into every kernel source's fault
    register, on the current stream of each device the library has
    launched on. Before the library is loaded there is nothing to write:
    :func:`load` writes it at the first launch on each device."""
    with _lock:
        if _lib is None:
            return
        for index in sorted(_devices):
            _write_register(_lib, index)


def check(code: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` on a non-zero CUDA error code."""
    if code != 0:
        raise KernelLaunchError(
            f"{what}: launch failed with CUDA error {code} "
            "(cudaGetLastError); see cuda_runtime_api.h for the code")


def current_stream() -> int:
    """PyTorch's current CUDA stream as the integer handle the C entries take."""
    import torch

    return torch.cuda.current_stream().cuda_stream
