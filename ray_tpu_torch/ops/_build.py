"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``ray_tpu_torch/_build/<name>-<hash>.so``, where the hash covers the
sources and the flags, so an edited source builds anew and an unchanged
one is built once. The library has a plain C interface and is loaded with
``ctypes``; nothing here includes PyTorch's headers, which keeps a build
to seconds. The compiler's output (``-Xptxas -v``: registers, shared
memory and spills of every kernel) is kept beside the library as
``<name>-<hash>.log``.

Nothing is built when this module is imported: ``load_library`` builds at
first use, and ``build`` lets a caller start several builds at once.

The calling convention the kernel wrappers share lives here too: a CPU
tensor takes the plain version and a tensor subclass (a DTensor) raises
(``on_cpu``), a launcher gets PyTorch's current stream (``stream``), and
``launch`` raises on a non-zero ``cudaError_t`` (``raise_on_error``) and
counts only launches that were accepted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    # PyTorch's own lookup: CUDA_HOME / CUDA_PATH, then nvcc on PATH, then
    # the toolkit's default install location.
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of every source
    in ``csrc/`` (headers included) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, float]:
    """Build the named libraries that are not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds each build took
    (0.0 for one that was already built). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        started[name] = (proc, log, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, out, t0) in started.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            text = out.with_suffix(".log").read_text()[-4000:]
            failed.append(f"nvcc failed for {name} (exit {rc}):\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def on_cpu(x) -> bool:
    """True for a CPU tensor, False for a CUDA one; raises for any other
    device rather than guess which path it should take, and for a tensor
    subclass (a DTensor, for one): the kernels and their plain versions
    take plain local tensors."""
    import torch

    if type(x) is not torch.Tensor and type(x) is not torch.nn.Parameter:
        raise TypeError(f"the kernel wrappers take plain tensors, got "
                        f"{type(x).__name__}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the int a launcher
    takes for its ``cudaStream_t``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(name: str, rc: int) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


_COUNT_LOCK = threading.Lock()


def launch(counter, name: str, fn, *args) -> None:
    """Call the C launcher ``fn``; raise if it returns a CUDA error, else
    add one to ``counter[name]`` (under a lock: threads of one process, such
    as two Tune trials sharing a card, launch at once, and ``+=`` on a
    dict is a read and a write)."""
    raise_on_error(name, fn(*args))
    with _COUNT_LOCK:
        counter[name] += 1
