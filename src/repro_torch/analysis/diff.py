"""Change-scoped analysis: which ops does a diff actually touch?

Counterpart of ``repro.analysis.diff``. ``python -m repro_torch.analysis
--diff <ref>`` analyzes only the ops whose datapath sources changed
relative to a git ref, instead of the full matrix.

The mapping is deliberately coarse and fails safe:

* each registered op owns the files that implement *only* it — its
  Python module and its CUDA sources (:data:`OP_SOURCES`); a file two ops
  share (``logmatmul.py``, ``elemwise.cu``, ``flash_attention.py``, whose
  finalize the decode step runs) maps to both;
* everything the ops share — the datapath on both sides, the registry,
  the build, all of ``core/`` and the analyzer itself — is
  :data:`SHARED_SOURCES`: touching any of it means "analyze everything"
  (returns ``None``, the ``run_matrix(ops=None)`` sentinel);
* a diff touching none of the mapped sources returns ``()`` — no ops to
  re-verify (the lint pass still runs; it is repo-wide and cheap).

Pure path logic (:func:`ops_for_paths`) is separated from the git query
(:func:`changed_paths`) so the mapping is unit-testable without a
repository.
"""
from __future__ import annotations

import subprocess

__all__ = ["OP_SOURCES", "SHARED_SOURCES", "changed_paths",
           "ops_for_paths"]

_K = "src/repro_torch/kernels/"
_C = _K + "csrc/"

#: op name -> source files (repo-relative, forward slashes) implementing
#: that op, Python and CUDA
OP_SOURCES: dict[str, tuple] = {
    "elemwise": (_K + "elemwise.py", _C + "elemwise.cu"),
    "sqrt": (_K + "elemwise.py", _C + "elemwise.cu"),
    "packed": (_K + "packed_simd.py", _C + "packed_simd.cu",
               "src/repro_torch/core/simd_pack.py"),
    "matmul_int": (_K + "logmatmul.py", _C + "logmatmul.cu",
                   _C + "logmatmul.cuh", _C + "logmatmul_wide.cu"),
    "matmul_emul": (_K + "logmatmul.py", _C + "logmatmul.cu",
                    _C + "logmatmul.cuh", _C + "logmatmul_wide.cu"),
    "attention": (_K + "flash_attention.py", _C + "flash_attention.cu",
                  _C + "flash_attention_w32.cu", _C + "flash_attention.cuh"),
    "decode_attention": (_K + "decode_attention.py", _K + "flash_attention.py",
                         _C + "decode_attention.cu",
                         _C + "decode_attention_w32.cu",
                         _C + "decode_attention.cuh"),
}

#: prefixes/files shared by every op: touching any of these re-verifies
#: the full matrix. Directories end with '/' and match by prefix.
SHARED_SOURCES: tuple = (
    _K + "datapath.py",
    _C + "simdive_datapath.cuh",
    _C + "cp_async.cuh",
    _K + "registry.py",
    _K + "ops.py",
    _K + "build.py",
    "src/repro_torch/core/",
    "src/repro_torch/analysis/",
)


def changed_paths(ref: str, repo_root: str | None = None) -> tuple:
    """Repo-relative paths changed vs ``ref`` (committed + worktree).

    ``git diff --name-only <ref>`` — includes uncommitted edits, which is
    what a pre-push iteration loop wants. Raises ``RuntimeError`` with
    git's stderr on a bad ref: a typo'd ref must not silently analyze
    nothing.
    """
    cmd = ["git", "diff", "--name-only", ref]
    proc = subprocess.run(cmd, cwd=repo_root, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"git diff --name-only {ref!r} failed: "
            f"{proc.stderr.strip() or proc.stdout.strip()}")
    return tuple(p.strip() for p in proc.stdout.splitlines() if p.strip())


def ops_for_paths(paths, known_ops) -> tuple | None:
    """The op subset a set of changed paths requires re-analyzing.

    Returns ``None`` for "the full matrix" (a shared source changed, or
    an op in :data:`OP_SOURCES` is not in ``known_ops`` — a stale map
    must widen, never narrow), a tuple of op names otherwise (possibly
    empty: nothing datapath-relevant changed).
    """
    known = set(known_ops)
    # the map widening-checks itself: an OP_SOURCES key the registry no
    # longer knows means this module is out of date — full matrix
    if not set(OP_SOURCES) <= known:
        return None
    hit: set = set()
    for p in paths:
        path = p.replace("\\", "/")
        for shared in SHARED_SOURCES:
            if (path.startswith(shared) if shared.endswith("/")
                    else path == shared):
                return None
        for op, sources in OP_SOURCES.items():
            if path in sources:
                hit.add(op)
    return tuple(sorted(hit))
