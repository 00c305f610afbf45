"""Build and load the CUDA kernels under ``kernels/csrc``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  All sources are compiled in
parallel, one ``nvcc`` per file, at the first use of any kernel; the
libraries go to ``build/repro_torch/<hash>/`` at the repository root,
keyed on a hash of every source and the compiler flags, so an edited
source triggers a rebuild and an unchanged one is reused.

Every C entry point returns ``cudaGetLastError()`` (or the error of the
shared-memory attribute call before it); :func:`check` raises
:class:`KernelLaunchError` on any non-zero code, so a launch the card
refuses never passes silently.  A missing ``nvcc`` or a failed build
raises :class:`KernelBuildError`: nothing here falls back to the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# argtypes of every C entry point, by library name
SIGNATURES = {
    "chunk_sort": {
        "zipper_chunk_sort": ([_P, _P, _P] + [_I] * 4 + [_P] * 4, _I),
        "zipper_empty_launch": ([_P], _I),
    },
    "merge_partitions": {
        "zipper_merge_partitions": ([_P] * 6 + [_I] * 5 + [_P] * 10, _I),
        "zipper_merge_scratch_words": ([_I] * 5, _L),
        "zipper_merge_table_words": ([_I] * 4, _L),
    },
    "stream_sort": {
        "zipper_stream_sort": ([_P, _P, _P] + [_I] * 5 + [_P] * 4, _I),
    },
    "stream_merge": {
        "zipper_stream_merge": ([_P] * 6 + [_I] * 2 + [_P] * 8, _I),
        "zipper_stream_merge_ptr": ([_P, _P, _L, _P, _P, _P, _L, _P, _I, _I]
                                    + [_P] * 5 + [_L] + [_P] * 4, _I),
    },
    "fused_bucket": {
        "zipper_fused_bucket": ([_P] * 3 + [_I] * 6 + [_P] * 6 + [_I, _P],
                                _I),
        "zipper_fused_expand": ([_P, _P, _I] + [_P] * 6 + [_I] * 10
                                + [_P] * 6 + [_I, _P], _I),
    },
    "flash_attention": {
        "zipper_flash_attention": ([_P] * 4 + [_I] * 7 + [_L] * 12
                                   + [ctypes.c_float, _I, _I, _P], _I),
    },
    "grouped_matmul": {
        "zipper_grouped_matmul": ([_P] * 4 + [_I] * 9 + [_P], _I),
    },
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel source failed to compile."""


class KernelLaunchError(RuntimeError):
    """The card refused a kernel launch, or a kernel faulted."""


class _Libraries:
    """The loaded kernel libraries of this process, built on first use."""

    def __init__(self):
        self._mu = threading.Lock()
        self._libs: dict[str, ctypes.CDLL] = {}
        self.build_dir: Path | None = None

    def get(self, name: str) -> ctypes.CDLL:
        with self._mu:
            if not self._libs:
                self._load_all()
            return self._libs[name]

    def _load_all(self) -> None:
        out_dir = build_all()
        for name, fns in SIGNATURES.items():
            lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
            for fn, (argtypes, restype) in fns.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            lib.zipper_error_string.argtypes = [_I]
            lib.zipper_error_string.restype = ctypes.c_char_p
            self._libs[name] = lib
        self.build_dir = out_dir


LIBS = _Libraries()
_ENTRIES: dict = {}


def entry(name: str, fn: str):
    """The C entry ``fn`` of library ``name``, resolved once per process
    (the first call builds and loads every library, under the lock)."""
    f = _ENTRIES.get((name, fn))
    if f is None:
        f = _ENTRIES[name, fn] = getattr(LIBS.get(name), fn)
    return f


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise KernelBuildError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) unless this source hash
    is already built; return the directory holding the ``.so`` files."""
    out_dir = BUILD_ROOT / source_hash()
    names = sorted(SIGNATURES)
    if all((out_dir / f"{n}.so").exists() for n in names):
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in names:
        tmp = out_dir / f"{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out_dir / f"{n}.so")
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out_dir


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) of the loaded build."""
    if LIBS.build_dir is None:
        return ""
    return "\n".join((LIBS.build_dir / f"{n}.log").read_text()
                     for n in sorted(SIGNATURES))


def cuda_inputs(*pairs):
    """Check (tensor, dtype) pairs for a kernel launch: one CUDA device,
    the dtype the kernel takes; return them contiguous."""
    dev = pairs[0][0].device
    out = []
    for t, dtype in pairs:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"kernel input has dtype {t.dtype}, "
                            f"the kernel takes {dtype}")
        out.append(t.contiguous())
    return out


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.zipper_error_string(err).decode()
        raise KernelLaunchError(f"{what}: CUDA error {err} ({msg})")
