"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds go
to ``build/torch_kernels/<hash of the sources and flags>/`` beside the
package, happen at first use (never at import), and are reused while the
sources are unchanged.  :func:`build_all` starts one ``nvcc`` per source at
once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# Per-source flags.  The capture and match kernels must reproduce their plain
# twins bit for bit, so FMA contraction is off in those files.
_FLAGS = {
    "capture": ["-fmad=false"],
    "align": [],
    "match": ["-fmad=false"],
}

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # nvcc's -Xptxas -v report per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _cmd(name: str, out: Path):
    return [
        _nvcc(), *_ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", *_FLAGS[name], "-o", str(out), str(_CSRC / f"{name}.cu"),
    ]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_ARCH + _FLAGS[name]).encode())
    return _BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build_all() -> float:
    """Compile every kernel source not yet built, one ``nvcc`` per source,
    all started together.  Returns the wall seconds spent building."""
    t0 = time.time()
    procs = {}
    for name in _FLAGS:
        out = _lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_cmd(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.time() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed with cudaError {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(fn, argv, device, kernel: str) -> None:
    """Call the launcher ``fn(*argv, stream)`` on ``device``'s current
    stream with ``device`` the thread's current CUDA device (a kernel runs
    on its stream's device only, and a process may hold tensors on a card
    other than its current one), then :func:`check` its error code."""
    import torch

    with torch.cuda.device(device):
        check(fn(*argv, stream_ptr(device)), kernel)
