"""Build and load the hand-written CUDA kernels and the host library; hold
the kernels' launch counts.

The kernels' sources are csrc/*.cu and the headers csrc/*.cuh that they
share. At first use they are compiled by nvcc
for sm_90a (Hopper), one nvcc process per source and all at once, and
linked into one shared library with a plain C interface that is loaded with
ctypes, so the build needs the CUDA toolkit and nothing of PyTorch's
headers. The library goes to build/kernels/<hash>/ beside the
package, keyed by a hash of the sources and the flags, and is reused while
neither changes. A failed build raises.

The host library (csrc/host_io.cpp: the FASTA parse, the 2-bit pack, the
supermer encoder's loops, the output formatter; bound in io/native.py) is
plain C++17 on std::thread, built at first use by the host's C++ compiler
($CXX, else g++, else c++) into build/host/<hash>/. Its hash covers the
source, the flags, the compiler's version line and the machine, because
build/ can travel with a working tree to another host. A failed build
raises with the compiler's errors.

The first load of the kernel library is a stage span of its own ("kernel
library load", runtime/timer.stage), so a process's first call shows it.

`launches` counts, per kernel wrapper, the calls that launched the kernel on
a device. Only the wrappers touch it, at their launch; `reset_launches`
clears it before a run whose kernel use is to be shown.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

from .runtime.timer import stage

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # The source with the most kernels sets the build's time: let nvcc
    # (12.1 or later) optimise its kernels on all cores.
    "-split-compile", "0",
)
_LIB_NAME = "libhysortk_kernels.so"

HOST_SOURCE = os.path.join(_CSRC_DIR, "host_io.cpp")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "host")
# No -march=native and no OpenMP: the library must run on whatever host
# the tree is copied to, with the compiler's runtime alone.
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
_HOST_LIB_NAME = "libhysortk_host.so"

launches = {
    "keybuild": 0, "radix_sort": 0, "fused_count": 0,
    "run_length_sum": 0, "merge_runs": 0,
    "fused_sort": 0, "block_sort": 0, "mix_keys": 0,
    "supermer_runs": 0, "supermer_pack": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sources() -> list[str]:
    return sorted(
        os.path.join(_CSRC_DIR, f)
        for f in os.listdir(_CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA "
        "kernels cannot be built"
    )


def library_path() -> str:
    """Path of the built library for the current sources (built if absent).
    The compiler's output, with ptxas' register and shared-memory report,
    is kept beside it as build.log."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    out_dir = os.path.join(BUILD_DIR, digest.hexdigest()[:16])
    lib_path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    cu_files = [p for p in sources() if p.endswith(".cu")]
    objects = [
        os.path.join(out_dir, f"{os.path.basename(p)[:-3]}.{tag}.o")
        for p in cu_files
    ]
    compiles = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(cu_files, objects)
    ]
    outputs = [proc.communicate() for proc in compiles]
    log = "".join(out + err for out, err in outputs)
    failed = [proc.returncode for proc in compiles if proc.returncode != 0]
    tmp_path = f"{lib_path}.{tag}"
    if not failed:
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp_path, *objects],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = [link.returncode]
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    for obj in objects:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        # The errors first: ptxas' report of the sources that did compile
        # can fill the log's tail.
        errors = "\n".join(
            line for line in log.splitlines() if "error" in line.lower()
        )
        raise RuntimeError(
            f"nvcc failed (exit {failed[0]}):\n{errors[:4000]}\n...\n{log[-4000:]}"
        )
    os.replace(tmp_path, lib_path)
    return lib_path


def find_cxx() -> str:
    """The host C++ compiler: $CXX when set (as given: a missing one fails
    the build), else g++, else c++ on PATH."""
    if os.environ.get("CXX"):
        return os.environ["CXX"]
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler: $CXX is unset and neither g++ nor c++ "
                       "is on PATH; the host library cannot be built")


def compiler_version(cxx: str) -> str:
    """The first line of `cxx --version`; raises if the compiler does not
    run."""
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"C++ compiler {cxx!r} does not run: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed (exit {proc.returncode}):\n"
                           f"{proc.stderr[-2000:]}")
    return (proc.stdout.splitlines() or [""])[0].strip()


def host_library_path() -> str:
    """Path of the host library built from csrc/host_io.cpp (built if
    absent), under HOST_BUILD_DIR/<hash>/ with the compiler's output beside
    it as build.log."""
    cxx = find_cxx()
    version = compiler_version(cxx)
    digest = hashlib.sha256(
        "\0".join([*HOST_FLAGS, version, platform.machine()]).encode())
    with open(HOST_SOURCE, "rb") as f:
        digest.update(f.read())
    out_dir = os.path.join(HOST_BUILD_DIR, digest.hexdigest()[:16])
    lib_path = os.path.join(out_dir, _HOST_LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp_path, HOST_SOURCE],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"{cxx} could not build {HOST_SOURCE}: {exc}") from exc
    log = f"{cxx} ({version})\n{proc.stdout}{proc.stderr}"
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise RuntimeError(
            f"{cxx} failed (exit {proc.returncode}) on {HOST_SOURCE}:\n{log[-4000:]}")
    os.replace(tmp_path, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            with stage("kernel library load"):
                _lib = _bind(ctypes.CDLL(library_path()))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.hk_keybuild.argtypes = [ptr, ptr, i64, i32, ptrs, ptr]
    lib.hk_keybuild.restype = i32
    lib.hk_radix_sort_scratch.argtypes = [i64]
    lib.hk_radix_sort_scratch.restype = i64
    lib.hk_radix_sort.argtypes = [ptrs, ptrs, ptrs, i32, i32, i64, ptr, ptr]
    lib.hk_radix_sort.restype = i32
    lib.hk_fused_sort.argtypes = [ptr, ptr, i64, i32, ptrs, ptrs, ptr, ptr]
    lib.hk_fused_sort.restype = i32
    lib.hk_block_sort.argtypes = [ptrs, ptrs, i32, i32, i64, i64, i32, ptr]
    lib.hk_block_sort.restype = i32
    lib.hk_fused_count_scratch.argtypes = [i64]
    lib.hk_fused_count_scratch.restype = i64
    lib.hk_fused_count.argtypes = [ptrs, i32, i64, i32, i32, ptr, ptr, ptr, ptr]
    lib.hk_fused_count.restype = i32
    lib.hk_run_length_sum_scratch.argtypes = [i64]
    lib.hk_run_length_sum_scratch.restype = i64
    lib.hk_run_length_sum.argtypes = [ptrs, i32, ptr, i64, ptr, ptr, ptr, ptr]
    lib.hk_run_length_sum.restype = i32
    lib.hk_merge_pass.argtypes = [ptrs, ptrs, i32, i32, ptr, i32, ptr, i32,
                                  i32, i32, i32, ptr, ptr]
    lib.hk_merge_pass.restype = i32
    u32s = ctypes.POINTER(ctypes.c_uint32)
    lib.hk_mix_keys.argtypes = [ptrs, ptrs, i32, i64, u32s, i32, u32s, ptr]
    lib.hk_mix_keys.restype = i32
    lib.hk_supermer_runs_scratch.argtypes = [i64]
    lib.hk_supermer_runs_scratch.restype = i64
    lib.hk_supermer_runs_count.argtypes = [ptr, ptr, i64, i32, ptr, ptr, ptr]
    lib.hk_supermer_runs_count.restype = i32
    lib.hk_supermer_runs_write.argtypes = [ptr, ptr, i64, i32, ptr, ptr, ptr, ptr, ptr]
    lib.hk_supermer_runs_write.restype = i32
    lib.hk_supermer_pack.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                                     i32, ptr, ptr]
    lib.hk_supermer_pack.restype = i32
    lib.hk_error_string.argtypes = [i32]
    lib.hk_error_string.restype = ctypes.c_char_p
    return lib


def pointer_array(tensors) -> ctypes.Array:
    """A C array of the tensors' device addresses (void* const*)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        text = lib().hk_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({text})")
