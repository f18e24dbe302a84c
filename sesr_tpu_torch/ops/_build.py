"""Build ``csrc/*.cu`` with nvcc into ``build/kernels/`` and load it.

Route (b) of a hand-written kernel: a shared library with a plain C
interface (no PyTorch header, so nvcc takes seconds), loaded with ctypes.
The library's name carries a hash of its source and flags, so an edited
source builds anew and an unchanged one loads from the build directory.
Nothing is built when this module is imported: ``load()`` builds at first
use.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE / "csrc" / "sesr_net.cu"
BUILD_DIR = PACKAGE.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# the two network entry points share one signature:
# (x, out, weights, params, n, h, w, num_layers, in_ch, out_ch, tile_h, tile_w, stream)
NET_ARGTYPES = [_PTR, _PTR, _PTR, _PTR] + [_INT] * 8 + [_PTR]


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path          # the shared library
    seconds: float      # nvcc wall time; 0.0 when an earlier build was reused
    log: str            # nvcc's output, with the -Xptxas -v register report


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the fused kernels are built from source at first use")
    return nvcc


def build() -> Build:
    """Compile the kernels' library unless a build of this exact source and
    flag set exists. Raises RuntimeError with nvcc's output on failure."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libsesr_net-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Build(lib, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib)          # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Build(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, with every entry point's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build().path))
    for name in ("sesr_pe_exact_net", "sesr_fast_net"):
        fn = getattr(lib, name)
        fn.argtypes = NET_ARGTYPES
        fn.restype = _INT
    lib.sesr_error_string.argtypes = [_INT]
    lib.sesr_error_string.restype = ctypes.c_char_p
    return lib
