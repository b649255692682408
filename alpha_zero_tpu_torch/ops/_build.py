"""Builds the port's CUDA kernels with ``nvcc``, loads them with ctypes and
launches them: the one path from a wrapper in ``ops/`` to its kernel.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/kernels/lib<name>-<hash>.so`` at the repository
root. The hash covers the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is built when a
module is imported: the first call that launches a kernel builds it.

A wrapper names its library by a signature table, ``(name, {entry:
argtypes})``: each ``extern "C" int`` entry of ``csrc/<name>.cu`` with the
ctypes types of its arguments before the stream, which every entry takes
last (pointers as ``c_void_p`` or ``POINTER``, so that ctypes does not cut
them to 32 bits). Every source also exports ``azt_cuda_error_string``.
``launch`` makes the tensors' device current, passes its current stream,
raises on an error code and says whether the launch counts: a call made
while the stream is being captured into a CUDA graph only records the
kernel, and the graph's replays do not pass through here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# -fmad=false: no multiply-add contraction, so each kernel rounds after
# every operation exactly as its plain PyTorch version does. No fast math.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compiles every source that has no current library, one ``nvcc``
    process per source, all started together. Returns each source's
    ``-Xptxas -v`` report (register and shared-memory use)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources():
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build_all()
    return ctypes.CDLL(str(path))


Library = Tuple[str, Dict[str, Sequence[type]]]

_loaded: Dict[str, ctypes.CDLL] = {}


def _declare(library: Library) -> ctypes.CDLL:
    name, signatures = library
    lib = load(name)
    for entry, argtypes in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.azt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.azt_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def launch(library: Library, entry: str, device: torch.device, *args) -> bool:
    """Calls ``entry`` of ``library`` with ``args`` and the current stream
    of ``device``, with ``device`` made current if it is not. Raises
    ``RuntimeError`` on a non-zero code. Returns whether the launch counts:
    False while the stream is being captured."""
    lib = _loaded.get(library[0]) or _declare(library)
    if device.index in (None, torch.cuda.current_device()):
        return _call(lib, entry, device, args)
    with torch.cuda.device(device):
        return _call(lib, entry, device, args)


def _call(lib: ctypes.CDLL, entry: str, device: torch.device, args) -> bool:
    rc = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           + lib.azt_cuda_error_string(rc).decode())
    return not torch.cuda.is_current_stream_capturing()
