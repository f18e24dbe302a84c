"""Build each ``csrc/<name>.cu`` with nvcc into ``build/kernels/`` and load it.

Route (b) of a hand-written kernel: one shared library per source, with a
plain C interface (no PyTorch header, so nvcc takes seconds), loaded with
ctypes. A library's file name carries a hash of its own source, of every
``csrc/`` header that source includes (``#include "x.cuh"``, followed into
headers), and of the flags, so an edited source or header builds anew, an
unchanged one loads from the build directory, and editing one source
leaves the other libraries' names as they were. Nothing is built when
this module is imported: ``load(name)`` builds at first use.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "kernels"
# --split-compile 0: the optimizer runs on every CPU at once, kernel by kernel
# (sesr_net.cu holds 24 instantiations since the 32-channel ones). The
# layer-group libraries (sesr_net_group.cu, sesr_corrected_group.cu) include
# sesr_net.cu / sesr_corrected.cu for their bodies, the libraries of other
# conv sizes (sesr_net_ksize.cu, sesr_corrected_ksize.cu and its counting
# form's, sesr_corrected_ksize_audit.cu) the group sources, and their
# width-64 libraries (sesr_net_w64.cu, sesr_corrected_w64.cu,
# sesr_corrected_w64_audit.cu) the ksize sources; each builds beside the
# others, one nvcc process a library.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
# every entry point of each library, with its argument types; each returns
# a cudaError_t as int, and each library exports <prefix>_error_string
SIGNATURES = {
    "sesr_net": {
        # (x, out, weights, params, n, h, w, num_layers, in_ch, out_ch, tile_h, tile_w, split,
        #  pe, general, width, stream)
        "sesr_pe_exact_net": [_PTR] * 4 + [_INT] * 12 + [_PTR],
        # (x, out, weights, params, n, h, w, num_layers, in_ch, out_ch, tile_h, tile_w,
        #  general, width, stream)
        "sesr_fast_net": [_PTR] * 4 + [_INT] * 10 + [_PTR],
        # (exact, num_layers, in_ch, out_ch, tile_h, tile_w, split, pe, general, width) ->
        # shared memory bytes, 0: refused
        "sesr_net_smem": [_INT] * 10,
    },
    "sesr_corrected": {
        # (x, out, weights, params, n, h, w, num_layers, in_ch, out_ch, tile_h, tile_w, split,
        #  pe, general, width, stream)
        "sesr_corrected_net": [_PTR] * 4 + [_INT] * 12 + [_PTR],
        # the counting form: sesr_corrected_net's arguments but the stream, then
        # (counts, y0, y1, x0, x1, stream)
        "sesr_corrected_audit": [_PTR] * 4 + [_INT] * 12 + [_PTR] + [_INT] * 4 + [_PTR],
        # (num_layers, in_ch, out_ch, tile_h, tile_w, split, pe, general, width) -> shared
        # memory bytes, 0: refused
        "sesr_corrected_smem": [_INT] * 9,
    },
    "sesr_net_group": {
        # (exact, x, out, weights, params, sc, nb, h, w, convs, flags, in_ch, out_ch, tile_h,
        #  tile_w, split, pe, general, width, stream)
        "sesr_net_group": [_INT] + [_PTR] * 5 + [_INT] * 13 + [_PTR],
        # (exact, convs, flags, in_ch, out_ch, tile_h, tile_w, split, pe, width) -> shared
        # memory bytes, 0: refused
        "sesr_net_group_smem": [_INT] * 10,
    },
    "sesr_corrected_group": {
        # (x, out, weights, params, sc, nb, h, w, convs, flags, in_ch, out_ch, tile_h, tile_w,
        #  split, pe, general, width, stream)
        "sesr_corrected_group": [_PTR] * 5 + [_INT] * 13 + [_PTR],
        # the counting form: the same arguments but the stream, then (counts, y0, y1, x0,
        # x1, stream)
        "sesr_corrected_group_audit": [_PTR] * 5 + [_INT] * 13 + [_PTR] + [_INT] * 4 + [_PTR],
        # (convs, flags, in_ch, out_ch, tile_h, tile_w, split, pe, width) -> shared memory
        # bytes, 0: refused
        "sesr_corrected_group_smem": [_INT] * 9,
    },
    "sesr_net_ksize": {
        # sesr_net_group's arguments but the stream, then (ks: the group's conv sizes, four
        # bits a conv; stream)
        "sesr_net_ksize": [_INT] + [_PTR] * 5 + [_INT] * 13 + [_LL, _PTR],
        # sesr_net_group_smem's arguments, then ks
        "sesr_net_ksize_smem": [_INT] * 10 + [_LL],
    },
    "sesr_corrected_ksize": {
        # sesr_corrected_group's arguments but the stream, then (ks, stream)
        "sesr_corrected_ksize": [_PTR] * 5 + [_INT] * 13 + [_LL, _PTR],
        # sesr_corrected_group_smem's arguments, then ks
        "sesr_corrected_ksize_smem": [_INT] * 9 + [_LL],
    },
    "sesr_corrected_ksize_audit": {
        # the counting form: sesr_corrected_ksize's arguments but the stream, then
        # (counts, y0, y1, x0, x1, stream)
        "sesr_corrected_ksize_audit": [_PTR] * 5 + [_INT] * 13 + [_LL, _PTR] + [_INT] * 4
                                      + [_PTR],
    },
    # the forms of other conv sizes at width 64: the ksize libraries' arguments
    "sesr_net_w64": {
        "sesr_net_w64": [_INT] + [_PTR] * 5 + [_INT] * 13 + [_LL, _PTR],
        "sesr_net_w64_smem": [_INT] * 10 + [_LL],
    },
    "sesr_corrected_w64": {
        "sesr_corrected_w64": [_PTR] * 5 + [_INT] * 13 + [_LL, _PTR],
        "sesr_corrected_w64_smem": [_INT] * 9 + [_LL],
    },
    "sesr_corrected_w64_audit": {
        "sesr_corrected_w64_audit": [_PTR] * 5 + [_INT] * 13 + [_LL, _PTR] + [_INT] * 4
                                    + [_PTR],
    },
    "probes": {
        # (a, b, out, out_x, out_f32, m, n, k, in_bf16, epilogue, rep, stream)
        "probe_gemm": [_PTR] * 5 + [_INT] * 6 + [_PTR],
        # (x, w, bufs, out_f32, count, base, eh, ew, c, iters, in_bf16, stream)
        "probe_conv_run": [_PTR] * 5 + [ctypes.c_uint] + [_INT] * 5 + [_PTR],
        # (words, out, m, n, roll, stream)
        "probe_unpack_words": [_PTR] * 2 + [_INT] * 3 + [_PTR],
        # (words, w, out, m, n, p, roll, stream)
        "probe_bitcast_dot": [_PTR] * 3 + [_INT] * 4 + [_PTR],
        # (words, wb, out, m, k_words, n, out_f32, stream)
        "probe_packed_dot": [_PTR] * 3 + [_INT] * 4 + [_PTR],
    },
}
ERROR_STRING = {"sesr_net": "sesr_error_string", "sesr_corrected": "sesr_corrected_error_string",
                "sesr_net_group": "sesr_net_group_error_string",
                "sesr_corrected_group": "sesr_corrected_group_error_string",
                "sesr_net_ksize": "sesr_net_ksize_error_string",
                "sesr_corrected_ksize": "sesr_corrected_ksize_error_string",
                "sesr_corrected_ksize_audit": "sesr_corrected_ksize_audit_error_string",
                "sesr_net_w64": "sesr_net_w64_error_string",
                "sesr_corrected_w64": "sesr_corrected_w64_error_string",
                "sesr_corrected_w64_audit": "sesr_corrected_w64_audit_error_string",
                "probes": "probe_error_string"}


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
                           "the kernels are built from source at first use")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly or
    through another header, in the order first included."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / inc.decode()
            if header.exists() and header not in found:
                found.append(header)
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built: the
    name carries a hash of that source, the headers it includes and the
    flags."""
    if name not in SIGNATURES:
        raise ValueError(f"no kernel library {name!r}; known: {sorted(SIGNATURES)}")
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


_LOCKS = defaultdict(threading.Lock)       # one build of a library at a time


def build(name: str, nice: int = 0) -> Build:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    flag set exists (a build of it in progress in another thread is waited
    for). ``nice``: nvcc's scheduling priority, lowered by that much (a
    build that may run beside other work). Raises RuntimeError with nvcc's
    output on failure."""
    with _LOCKS[name]:
        return _build(name, nice)


def _build(name: str, nice: int) -> Build:
    lib = library_path(name)
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Build(lib, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                             preexec_fn=(lambda: os.nice(nice)) if nice else None)
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


def build_all() -> dict[str, Build]:
    """Every library, one nvcc per source, all started together."""
    with ThreadPoolExecutor(len(SIGNATURES)) as pool:
        return dict(zip(SIGNATURES, pool.map(build, SIGNATURES)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(str(build(name).path))
    for symbol, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = _INT
    err = getattr(lib, ERROR_STRING[name])
    err.argtypes = [_INT]
    err.restype = ctypes.c_char_p
    return lib


def error_string(name: str, err: int) -> str:
    return getattr(load(name), ERROR_STRING[name])(err).decode()


def ptxas_report(log: str, family: str) -> dict:
    """{template arguments as mangled, e.g. "Li0ELi12ELb1": (registers,
    spill store bytes)} of each instantiation of the kernel ``family`` in a
    library's -Xptxas -v build log (``Build.log``)."""
    report, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(family + r"I(.*?)EE", line)
        if "Compiling entry function" in line and m:
            near = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", near)
            spill = re.search(r"(\d+) bytes spill stores", near)
            report[m.group(1)] = (int(regs.group(1)) if regs else None,
                                  int(spill.group(1)) if spill else None)
    return report
