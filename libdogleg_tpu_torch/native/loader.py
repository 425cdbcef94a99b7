"""Builds and loads the package's CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc, one process per source, all
started together, and linked into one shared library with a plain C
interface, under _build/ beside this file, and loaded with ctypes. The
library's file name carries a hash of the sources, their shared headers
(csrc/*.cuh) and the flags, so an edit rebuilds it and a stale build is never
loaded. Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import NamedTuple, Optional

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
# No --use_fast_math: the solver's NaN-rho rule needs IEEE comparisons and
# the pivot test needs isfinite. -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class BuildInfo(NamedTuple):
    path: pathlib.Path  # the shared library
    seconds: float      # compile time; 0.0 when an existing build was found
    log: str            # nvcc's output (ptxas register and spill report)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit PyTorch's
    cpp_extension module locates. Raises if there is none."""
    def in_home(home):
        nvcc = pathlib.Path(home) / "bin" / "nvcc" if home else None
        return str(nvcc) if nvcc is not None and nvcc.is_file() else None

    found = in_home(os.environ.get("CUDA_HOME")) or shutil.which("nvcc")
    if not found:
        from torch.utils.cpp_extension import CUDA_HOME
        found = in_home(CUDA_HOME)
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH")
    return found


def _sources():
    srcs = sorted(_SRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {_SRC}")
    return srcs


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources() + sorted(_SRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return _BUILD_DIR / f"libdogleg_tpu_torch_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands concurrently; raise with the output of any that
    fails. Returns the output of each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=900)
            outs.append(out)
            if proc.returncode:
                failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return outs


def build() -> BuildInfo:
    """Compile csrc/*.cu unless a build of the current sources exists."""
    so = library_path()
    if so.exists():
        return BuildInfo(so, 0.0, "")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, s.stem + ".o") for s in _sources()]
        log = "".join(_run([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o]
                            for s, o in zip(_sources(), objs)]))
        tmp = os.path.join(tmpdir, so.name)
        log += "".join(_run([[nvcc, "-shared", *NVCC_FLAGS[:2], *objs, "-o",
                              tmp]]))
        os.replace(tmp, so)  # atomic: a concurrent build never sees half
    return BuildInfo(so, time.perf_counter() - t0, log)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    bind_mega(lib)
    for dt in ("f32", "f64"):
        # W, B, p, L, Linv, ok, device, stream
        fn = getattr(lib, f"dogleg_panelchol_{dt}")
        fn.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, ptr]
        fn.restype = i32
        # vals, bm, bn, pair_i, pair_j, run_ptr, nout, out, device, stream
        fn = getattr(lib, f"dogleg_bcsr_jtj_{dt}")
        fn.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, ptr, i32, ptr]
        fn.restype = i32
        # vals, bm, bn, indptr, indices, v, nmeas, out, device, stream
        fn = getattr(lib, f"dogleg_bcsr_matvec_{dt}")
        fn.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, ptr, i32, ptr]
        fn.restype = i32
        # A, k, n, L, ok, device, stream
        for entry in ("tilechol", "batchchol"):
            fn = getattr(lib, f"dogleg_{entry}_{dt}")
            fn.argtypes = [ptr, i32, i32, ptr, ptr, i32, ptr]
            fn.restype = i32
        # D, C, k, n, m, X, device, stream
        fn = getattr(lib, f"dogleg_trisolve_right_{dt}")
        fn.argtypes = [ptr, ptr, i32, i32, i32, ptr, i32, ptr]
        fn.restype = i32
    # n, element size in bytes, device
    lib.dogleg_tilechol_in_shared.argtypes = [i32, i32, i32]
    lib.dogleg_tilechol_in_shared.restype = i32
    return lib


def bind_mega(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points of csrc/mega.cu (kernel K1 and its check
    kernels) on a library that holds them."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        # the general solve: p0, meas, gx, gy; the factored one: p0, h_hi,
        # h_lo, n2m_hi, n2m_lo, Ghi, Glo; then B, params, 9 outputs, device,
        # stream
        for name, ins in ((f"dogleg_mega_{dt}", 4),
                          (f"dogleg_mega_factored_{dt}", 7)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * ins + [i32, ptr] + [ptr] * 9 + [i32, ptr]
            fn.restype = i32
        # the same inputs, B, norm2, jtx, jtj, device, stream
        for name, ins in ((f"dogleg_products_{dt}", 4),
                          (f"dogleg_factored_products_{dt}", 7)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * ins + [i32] + [ptr] * 3 + [i32, ptr]
            fn.restype = i32
        # a, b, n, p, e_p, s, e_s, device, stream
        fn = getattr(lib, f"dogleg_error_free_{dt}")
        fn.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr, i32, ptr]
        fn.restype = i32
    # 0 for the general instance, 1 for the factored one
    lib.dogleg_mega_group.argtypes = [i32]
    lib.dogleg_mega_group.restype = i32
    return lib


def launch_target(device) -> tuple:
    """(device index, handle of PyTorch's current stream on it), the last
    two arguments of every entry point. The handle comes straight from the
    runtime binding where this PyTorch has it: building a torch.cuda.Stream
    object for the same handle costs the host as much as a small kernel's
    launch."""
    import torch
    index = device.index or 0
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return index, torch.cuda.current_stream(index).cuda_stream
    return index, raw(index)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and cached in the process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build().path)))
        return _LIB
