"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles with ``nvcc`` into a shared library of
its own with a plain C interface. No PyTorch header is included, so a build
takes seconds. A library's file name carries a hash of its source, of the
headers it includes from ``csrc/`` and of the flags, so an edited source or
header rebuilds and a stale library is never loaded. Libraries go to
``build/kernels/`` at the root of the checkout. ``function`` sets a C
function's argument and result types once, when its library loads, so a
wrapper's call does no ctypes set-up.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.

A wrapper given ``meta`` tensors builds and launches nothing: it calls
``meta_launch`` with the bytes its kernel reads and writes, and returns
``meta`` outputs of the kernel's shapes. A meta trace
(``launch.roofline.MetaTrace``) listens there, so it counts a hand kernel
as the kernel's own traffic, not as the passes of its plain version.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("staleness_agg", "fused_adam", "topk", "quant8", "flash_attention")

_LIBS: dict[str, ctypes.CDLL] = {}   # loaded libraries, one per source
_FUNCS: dict[tuple[str, str], object] = {}   # configured C functions
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)
LISTENERS: list = []   # fn(name, read_bytes, written_bytes), see meta_launch


def meta_launch(name: str, read: int, written: int) -> None:
    """A kernel launch on ``meta`` tensors: nothing is built or run; each
    listener is told the kernel's own traffic, ``read`` bytes read once
    and ``written`` bytes written once."""
    for fn in LISTENERS:
        fn(name, int(read), int(written))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _sources(path: Path, seen: list) -> list:
    """``path`` and every file it includes with quotes, depth first."""
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu", []):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns each compiled
    source's compiler output (``-Xptxas -v``: registers, shared memory,
    spills). Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, errors = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def stream(t) -> int:
    """The current stream of tensor ``t``'s CUDA device as a raw handle,
    without the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` builds: host time that a kernel of a few
    microseconds would otherwise be bound by."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def function(name: str, symbol: str, restype, argtypes):
    """C function ``symbol`` of ``csrc/<name>.cu``, its ``restype`` and
    ``argtypes`` set once, when first asked for; later calls return the same
    configured object."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        _FUNCS[(name, symbol)] = fn
    return fn
