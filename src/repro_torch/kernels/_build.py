"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds into ``build/repro_torch_kernels/`` at the root
of the checkout (git-ignored). The library's file name carries a digest of
its source, the headers it includes from ``csrc/`` (``hopper.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("lora_matmul", "flash_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes, directly
    or through another header."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())
                 if (CSRC / inc.decode()).exists()]
    return out


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` each, all
    at once. Returns each compiled kernel's compiler output (register and
    shared-memory use); raises if any build fails."""
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, compiling it first if needed."""
    if name not in _libs:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def launch(lib: ctypes.CDLL, fn, name: str, device: torch.device, *args) -> None:
    """Call the C entry ``fn(*args, stream)`` on ``device``'s current stream
    and raise if it returned an error. The raw stream handle and the device
    switch (only when ``device`` is not the current one) keep the host's
    cost per launch small: decode launches hundreds of kernels a step."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return launch(lib, fn, name, device, *args)
    check(lib, fn(*args, torch._C._cuda_getCurrentRawStream(index)), name)


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{lib.repro_error_string(err).decode()}")
