"""Builds and loads the package's native libraries.

The CUDA kernels (csrc/*.cu) are compiled at first use with nvcc, one
process per source, all started together, and linked into one shared library
with a plain C interface, under _build/ beside this file, and loaded with
ctypes. The library's file name carries a hash of the sources, their shared
headers (csrc/*.cuh) and the flags, so an edit rebuilds it and a stale build
is never loaded.

The host library of the symbolic analysis (csrc/host/*.cpp: minimum degree,
the JtJ pair schedule, the block pattern of a scalar CSR pattern and the
symbolic factorization) is built apart from it, with g++, at its first use,
into the same directory under a name that carries the hash of its sources
and flags. It needs no nvcc and no card. Where it cannot be built or loaded,
`load_host_library` gives None and the callers take their Python forms, as
the JAX package's native path does.

The sources that parallel/mega_auto.py generates (kernel K1 on a products
functor traced from a torch function; they include csrc/dogleg_auto.cuh)
are built one library each by `build_generated`, with nvcc and the same
flags, under a name that carries the hash of the source, the headers and
the flags, so a second call with the same function builds nothing;
`build_generated_host` builds the same text with g++ for the CPU tests.

K1's host-side launch (csrc/launch.cpp: its checks, outputs and entry call,
ops/mega.py's CUDA branch) is a Python extension module built with g++
against PyTorch's headers and libraries by `build_launcher`, at the first
launch on a card, under a name that carries the hash of its source, the
flags, PyTorch's version and Python's; it needs no nvcc and no ninja.

Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
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

# The generated sources (K1 on a traced functor): no fused multiply-add in
# the solve's step math either (F2), so that a source's bits do not follow
# how nvcc happens to contract the code around its functor; the card then
# rounds as the host build does (GENERATED_HOST_FLAGS).
GENERATED_NVCC_FLAGS = ("-shared", *NVCC_FLAGS, "-fmad=false")

_HOST_SRC = _SRC / "host"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# The generated sources on the host, for the CPU tests: no fused
# multiply-add, as on the card (csrc/dogleg_auto.cuh); without -ffast-math
# no level of optimization reorders a sum, so the quickest build, -O0, gives
# the same arithmetic as any other.
GENERATED_HOST_FLAGS = ("-O0", "-shared", "-fPIC", "-std=c++17",
                        "-ffp-contract=off")

# K1's launcher (csrc/launch.cpp), a Python extension module: g++'s flags
# before PyTorch's ABI defines and the include paths (launcher_flags).
LAUNCH_SOURCE = _SRC / "launch.cpp"
LAUNCH_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++20")
LAUNCH_MODULE = "dogleg_launch"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LAUNCHER = None
_HOST_LIB: Optional[ctypes.CDLL] = None
_HOST_TRIED = False
_GENERATED: dict = {}   # (generated source, host) -> its bound library
# Seconds (perf_counter) spent in this process finding, building and loading
# libraries the process had not loaded yet (load_library, load_host_library,
# load_generated, load_launcher); a lookup of a loaded library adds nothing.
native_seconds = 0.0


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


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH")
    return found


def _sources():
    srcs = sorted(_SRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {_SRC}")
    return srcs


def library_path() -> pathlib.Path:
    return _BUILD_DIR / _hashed_name(
        "libdogleg_tpu_torch", NVCC_FLAGS,
        _sources() + sorted(_SRC.glob("*.cuh")))


def host_sources():
    return sorted(_HOST_SRC.glob("*.cpp"))


def host_library_path() -> pathlib.Path:
    return _BUILD_DIR / _hashed_name("libdogleg_tpu_torch_host", HOST_FLAGS,
                                     host_sources())


def _hashed_name(stem: str, flags, files) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in files:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return f"{stem}_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands concurrently; raise with the output of any that
    fails, or where one cannot be started. Returns the output of each, in
    order."""
    procs = []
    try:
        for c in cmds:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    except OSError as e:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise RuntimeError(f"compile failed: {' '.join(c)}: {e}") from e
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
        raise RuntimeError("compile failed: " + "\n".join(failed))
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


def build_host() -> BuildInfo:
    """Compile csrc/host/*.cpp with g++ into one library unless a build of
    the current sources exists. Raises where g++ is missing or fails."""
    so = host_library_path()
    if so.exists():
        return BuildInfo(so, 0.0, "")
    return _build_one(so, [_gxx(), *HOST_FLAGS, *map(str, host_sources())])


def _build_one(so: pathlib.Path, cmd, tail=()) -> BuildInfo:
    """Run `cmd` -o <a temporary name> `tail`, then rename the output to
    `so`, atomically."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, so.name)
        log = "".join(_run([[*cmd, "-o", tmp, *tail]]))
        os.replace(tmp, so)
    return BuildInfo(so, time.perf_counter() - t0, log)


def _generated_path(stem: str, source: str, flags) -> pathlib.Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.encode())
    for header in sorted(_SRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return _BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def generated_library_path(source: str) -> pathlib.Path:
    return _generated_path("libdogleg_auto", source, GENERATED_NVCC_FLAGS)


def _build_sources(sources, compiler, flags, path_of):
    """Each source not yet built into its library by `path_of`, compiled
    with `compiler` and `flags` (csrc/ on the include path), one process a
    source, all started together; each written under a temporary name and
    renamed. Returns a BuildInfo per source, in order; `seconds` is the
    wall of the builds together."""
    paths = [path_of(src) for src in sources]
    todo = [k for k, so in enumerate(paths) if not so.exists()]
    if not todo:
        return [BuildInfo(so, 0.0, "") for so in paths]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    logs = {}
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        cmds, tmps = [], []
        for k in todo:
            src = os.path.join(tmpdir, f"auto{k}.cu")
            with open(src, "w") as f:
                f.write(sources[k])
            tmps.append(os.path.join(tmpdir, paths[k].name))
            cmds.append([compiler(), *flags, "-I", str(_SRC), src, "-o",
                         tmps[-1]])
        for k, tmp, log in zip(todo, tmps, _run(cmds)):
            os.replace(tmp, paths[k])
            logs[k] = log
    seconds = time.perf_counter() - t0
    return [BuildInfo(so, seconds, logs[k]) if k in logs
            else BuildInfo(so, 0.0, "") for k, so in enumerate(paths)]


def build_generated(*sources: str):
    """Compile generated sources (parallel/mega_auto.py) with nvcc and
    GENERATED_NVCC_FLAGS, one shared library each holding both types'
    entries, unless a build of the same text, headers and flags exists
    under _build/. Returns a BuildInfo per source. Raises RuntimeError
    where nvcc is missing, cannot be started or fails."""
    return _build_sources(sources, find_nvcc, GENERATED_NVCC_FLAGS,
                          generated_library_path)


def build_generated_host(source: str) -> BuildInfo:
    """The same text built as host C++ with g++ (GENERATED_HOST_FLAGS): the
    entries dogleg_auto_host_solve_* and dogleg_auto_host_products_*, for
    the CPU tests. Raises RuntimeError where g++ is missing or fails."""
    return _build_sources(
        [source], _gxx, ("-x", "c++", *GENERATED_HOST_FLAGS),
        lambda src: _generated_path("libdogleg_auto_host", src,
                                    GENERATED_HOST_FLAGS))[0]


def bind_generated(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points of a generated library, built by nvcc
    (dogleg_auto_solve_*, dogleg_auto_products_*) or by g++
    (dogleg_auto_host_*)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        # p0, input pointers, B, params, 9 outputs[, device, stream]
        # p, input pointers, B, norm2, jtx, jtj[, device, stream]
        for prefix, tail in (("dogleg_auto_", [i32, ptr]),
                             ("dogleg_auto_host_", [])):
            fn = getattr(lib, f"{prefix}solve_{dt}", None)
            if fn is not None:
                fn.argtypes = [ptr, ptr, i32, ptr] + [ptr] * 9 + tail
                fn.restype = i32
                fn = getattr(lib, f"{prefix}products_{dt}")
                fn.argtypes = [ptr, ptr, i32] + [ptr] * 3 + tail
                fn.restype = i32
    for name in ("dogleg_auto_nstate", "dogleg_auto_inputs",
                 "dogleg_auto_group"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    return lib


def load_generated(source: str, host: bool = False) -> ctypes.CDLL:
    """The library of a generated source, built at its first use (nvcc, or
    g++ where `host`), bound and cached in the process by the source's
    text: a later call with the same text neither hashes nor builds."""
    global native_seconds
    key = (source, host)
    lib = _GENERATED.get(key)
    if lib is not None:
        return lib
    t0 = time.perf_counter()
    try:
        info = build_generated_host(source) if host else build_generated(
            source)[0]
        with _LOCK:
            if key not in _GENERATED:
                _GENERATED[key] = bind_generated(ctypes.CDLL(str(info.path)))
            return _GENERATED[key]
    finally:
        native_seconds += time.perf_counter() - t0


def _bind_host(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    i32p, i64p = ctypes.POINTER(i32), ctypes.POINTER(i64)
    lib.jtj_pair_count.restype = i64
    lib.jtj_pair_count.argtypes = [i32p, i32]
    lib.jtj_schedule.restype = i64
    lib.jtj_schedule.argtypes = [i32p, i32p, i32, i32, i32p, i32p, i32p,
                                 i32p, i32p]
    lib.bcsr_block_pattern.restype = i64
    lib.bcsr_block_pattern.argtypes = [i64p, i32p, i32, i32, i32, i32, i32p,
                                       i32p]
    lib.mindeg_order.restype = None
    lib.mindeg_order.argtypes = [i32p, i32p, i64, i32, i32p]
    lib.chol_symbolic_build.restype = ctypes.c_void_p
    lib.chol_symbolic_build.argtypes = [i32p, i32p, i64, i32]
    lib.chol_symbolic_free.restype = None
    lib.chol_symbolic_free.argtypes = [ctypes.c_void_p]
    lib.chol_symbolic_counts.restype = None
    lib.chol_symbolic_counts.argtypes = [ctypes.c_void_p, i64p]
    lib.chol_symbolic_export.restype = None
    lib.chol_symbolic_export.argtypes = [ctypes.c_void_p] + [i32p] * 26
    return lib


def load_host_library() -> Optional[ctypes.CDLL]:
    """The host library of the symbolic analysis, built on first use and
    cached in the process; None where it cannot be built or loaded (the
    callers then take their Python forms). One attempt a process."""
    global _HOST_LIB, _HOST_TRIED, native_seconds
    with _LOCK:
        if not _HOST_TRIED:
            _HOST_TRIED = True
            t0 = time.perf_counter()
            try:
                _HOST_LIB = _bind_host(ctypes.CDLL(str(build_host().path)))
            except (OSError, RuntimeError, AttributeError):
                _HOST_LIB = None
            native_seconds += time.perf_counter() - t0
        return _HOST_LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    bind_mega(lib)
    for dt in ("f32", "f64"):
        # W, B, p, L, Linv, ok, device, stream
        fn = getattr(lib, f"dogleg_panelchol_{dt}")
        fn.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, ptr]
        fn.restype = i32
        # vals, bm, bn, pair_i, pair_j, run_ptr, nout, batch, nnzb, out,
        # device, stream
        fn = getattr(lib, f"dogleg_bcsr_jtj_{dt}")
        fn.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32, ptr, i32,
                       ptr]
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
        # base, terms, uniq, run_ptr, term_pos, n_runs, outer, nbase,
        # nterm, inner, negate, device, stream
        fn = getattr(lib, f"dogleg_segment_add_{dt}")
        fn.argtypes = [ptr] * 5 + [i32] * 4 + [ctypes.c_int64, i32, i32,
                                               ptr]
        fn.restype = i32
    # base, terms, the address of a record of the other arguments, stream
    lib.dogleg_segment_add_planned.argtypes = [ptr] * 4
    lib.dogleg_segment_add_planned.restype = i32
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
    global _LIB, native_seconds
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            t0 = time.perf_counter()
            try:
                _LIB = _bind(ctypes.CDLL(str(build().path)))
            finally:
                native_seconds += time.perf_counter() - t0
        return _LIB


def launcher_flags():
    """(g++'s flags, the libraries to link) for K1's launcher: LAUNCH_FLAGS,
    the C++ ABI PyTorch was built with, PyTorch's headers and Python's;
    PyTorch's libraries. The paths are those torch.utils.cpp_extension
    gives, read from the installed package without importing that module
    (a quarter of a second)."""
    import torch
    root = pathlib.Path(torch.__file__).resolve().parent
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    flags = (*LAUNCH_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             f"-I{root / 'include'}", f"-I{sysconfig.get_paths()['include']}")
    lib = root / "lib"
    return flags, (f"-L{lib}", f"-Wl,-rpath,{lib}", "-lc10", "-ltorch",
                   "-ltorch_cpu", "-ltorch_python")


def launcher_path() -> pathlib.Path:
    """The launcher's build: its name carries the hash of the source, the
    flags and libraries, PyTorch's version and Python's."""
    import torch
    flags, libs = launcher_flags()
    return _BUILD_DIR / _hashed_name(
        LAUNCH_MODULE, (*flags, *libs, torch.__version__, sys.version),
        [LAUNCH_SOURCE])


def build_launcher() -> BuildInfo:
    """Compile csrc/launch.cpp with g++ unless a build of the same source,
    flags, PyTorch and Python exists. Raises RuntimeError where g++ is
    missing or fails."""
    so = launcher_path()
    if so.exists():
        return BuildInfo(so, 0.0, "")
    flags, libs = launcher_flags()
    return _build_one(so, [_gxx(), *flags, str(LAUNCH_SOURCE)], libs)


def load_launcher():
    """K1's launcher module (csrc/launch.cpp), built on first use and
    cached in the process. Raises RuntimeError where it cannot be built or
    imported."""
    global _LAUNCHER, native_seconds
    if _LAUNCHER is not None:
        return _LAUNCHER
    with _LOCK:
        if _LAUNCHER is None:
            t0 = time.perf_counter()
            try:
                path = build_launcher().path
                spec = importlib.util.spec_from_file_location(LAUNCH_MODULE,
                                                              path)
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                _LAUNCHER = module
            except ImportError as e:
                raise RuntimeError(f"K1's launcher {path} cannot be "
                                   f"imported: {e}") from e
            finally:
                native_seconds += time.perf_counter() - t0
        return _LAUNCHER
