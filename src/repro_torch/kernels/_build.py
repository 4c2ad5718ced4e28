"""Build and load the CUDA kernels of ``csrc/``.

``load()`` compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` — one
compiler process per source, all started together — links the objects into
one shared library with a plain C interface and opens it with ``ctypes``.
The library lands in ``build/repro_torch_kernels/`` at the root of the
checkout (override with ``REPRO_TORCH_BUILD_DIR``), named by a hash of the
sources and flags, so a second call — or a second process — reuses it and
an edited source rebuilds.  A failed build raises with ``nvcc``'s output.
``ptxas -v`` reports each kernel's registers, spills and static shared
memory; the report is kept beside the library (``*.ptxas.txt``) and
:func:`kernel_resources` and :func:`ptxas_warnings` read it.  A C7508
warning (``setmaxnreg`` ignored) fails the build.

``nvcc`` and ``ctypes`` are touched only inside ``load()``: importing this
module needs neither.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_seconds = 0.0       # wall time of the last real build (0 = cache hit)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> checkout root
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built here")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed, outs = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode:
            failed.append(f"$ {' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(outs)


def _build(lib_path: Path, srcs: list[Path]) -> None:
    nvcc = _find_nvcc()
    out_dir = lib_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [out_dir / f"{tag}.{s.stem}.o" for s in srcs]
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                        for s, o in zip(srcs, objs)])
        ignored = [ln for ln in log.splitlines() if "C7508" in ln]
        if ignored:
            # setmaxnreg ignored: the warp-specialised kernels would run
            # their consumers at the launch's register share
            raise RuntimeError("ptxas ignored setmaxnreg:\n" +
                               "\n".join(ignored))
        _report_path(lib_path).write_text(log)
        tmp = out_dir / f"{tag}.so"
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib_path)       # atomic: readers never see half
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


def _report_path(lib_path: Path) -> Path:
    return lib_path.with_suffix(".ptxas.txt")


def kernel_resources() -> dict:
    """Per compiled kernel (by its mangled name) the registers, spill
    stores / loads and stack bytes that ``ptxas -v`` reported when the
    library loaded by :func:`load` was built; empty if that report is
    missing."""
    if _lib is None:
        raise RuntimeError("kernel_resources() reads the report of the "
                           "library load() built: call load() first")
    path = _report_path(Path(_lib._name))
    if not path.is_file():
        return {}
    out, name, props = {}, None, None
    for line in path.read_text().splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif "Function properties for " in line:
            props = line.split("Function properties for ")[1].strip()
        elif props == name and name and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[name].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                             spill_load_bytes=nums[2])
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            out[name]["registers"] = int(words[words.index("Used") + 1])
    return out


def ptxas_warnings() -> list:
    """The warning lines of the ``ptxas -v`` report of the library
    :func:`load` built, and its "Potential Performance Loss" notes (wgmma
    serialised); a build with a C7508 "setmaxnreg ignored" warning fails,
    so none of those."""
    if _lib is None:
        raise RuntimeError("ptxas_warnings() reads the report of the "
                           "library load() built: call load() first")
    path = _report_path(Path(_lib._name))
    if not path.is_file():
        return []
    return [ln.strip() for ln in path.read_text().splitlines()
            if "warning" in ln.lower() or "Performance Loss" in ln]


def load():
    """The kernels' shared library as a ``ctypes.CDLL`` (built on first
    use, then cached in the process)."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        import ctypes
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        lib_path = build_dir() / f"libkernels_{_digest(srcs)}.so"
        if not lib_path.is_file():
            t0 = time.perf_counter()
            _build(lib_path, srcs)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        c_ptr, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.shard_factor_batch_launch.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ll,
            c_ptr]
        lib.shard_factor_batch_launch.restype = c_int
        lib.shard_factor_limits.argtypes = [
            ctypes.POINTER(c_int)] * 7
        lib.shard_factor_limits.restype = c_int
        lib.segmented_cummax_launch.argtypes = [
            c_ptr, c_ptr, c_int, c_ll, c_ptr]
        lib.segmented_cummax_launch.restype = c_int
        c_float = ctypes.c_float
        lib.flash_fwd_launch.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int,
            c_int, c_int, c_int, c_int, c_int, c_float, c_ptr]
        lib.flash_fwd_launch.restype = c_int
        lib.rmsnorm_fwd_launch.argtypes = [
            c_ptr, c_ptr, c_ptr, c_int, c_ll, c_int, c_float, c_ptr]
        lib.rmsnorm_fwd_launch.restype = c_int
        lib.rmsnorm_bwd_launch.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_ll, c_int, c_int,
            c_float, c_ptr]
        lib.rmsnorm_bwd_launch.restype = c_int
        lib.flash_fwd_wgmma_launch.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int,
            c_int, c_int, c_int, c_int, c_int, c_float, c_ptr]
        lib.flash_fwd_wgmma_launch.restype = c_int
        lib.flash_bwd_dkv_wgmma_launch.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int,
            c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_float,
            c_ptr]
        lib.flash_bwd_dkv_wgmma_launch.restype = c_int
        lib.flash_bwd_dq_wgmma_launch.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int,
            c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_float,
            c_ptr]
        lib.flash_bwd_dq_wgmma_launch.restype = c_int
        lib.flash_bwd_dq_launch.argtypes = \
            lib.flash_bwd_dq_wgmma_launch.argtypes
        lib.flash_bwd_dq_launch.restype = c_int
        lib.flash_bwd_dq_wgmma_encode.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int,
            c_int, c_int, c_int]
        lib.flash_bwd_dq_wgmma_encode.restype = c_int
        lib.flash_bwd_dkv_launch.argtypes = \
            lib.flash_bwd_dkv_wgmma_launch.argtypes
        lib.flash_bwd_dkv_launch.restype = c_int
        lib.flash_wgmma_plan.argtypes = [c_int, c_int, c_int,
                                         ctypes.POINTER(c_int)]
        lib.flash_wgmma_plan.restype = c_int
        lib.ssd_scan_launch.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int,
            c_int, c_int, c_int, c_int, ctypes.POINTER(c_ll), c_ll,
            ctypes.POINTER(c_ll), c_ptr]
        lib.ssd_scan_launch.restype = c_int
        lib.ssd_wgmma_launch.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr,
            c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
            ctypes.POINTER(c_ll), c_int, c_ptr]
        lib.ssd_wgmma_launch.restype = c_int
        lib.ssd_wgmma_plan.argtypes = [c_int, c_int, c_int,
                                       ctypes.POINTER(c_int)]
        lib.ssd_wgmma_plan.restype = c_int
        _lib = lib
        return lib
