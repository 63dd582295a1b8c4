"""Build the CUDA sources of ``kernels/csrc`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<hash>/<name>.so`` under
the checkout root, where ``<hash>`` covers every source, the headers they
include (``csrc/*.cuh``: the register sweep kernels' templates live there,
so that their float and bfloat16 entry points are two sources built in
parallel) and the compiler flags, so an edited source builds
anew and an unchanged one is reused.  The libraries have a plain C
interface and are loaded with ``ctypes``; no PyTorch header is compiled,
which keeps a build to seconds.  A build writes
to a temporary name and moves the result into place, so a build cut short
never leaves a library behind.  A failed build raises with nvcc's stderr;
a build that succeeds keeps nvcc's report (``-Xptxas -v``: registers,
spills, stack per kernel) beside its library as ``<name>.ptxas.txt``, and
``SECONDS`` holds each nvcc's wall time in the last build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("transpose", "sweep_far", "sweep1d_warp", "sweep1d_warp_bf16", "sweep2d_warp",
           "sweep2d_warp_bf16", "sweep3d", "sweep3d_bf16", "onestep", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
SECONDS: dict[str, float] = {}     # wall seconds of each nvcc of the last build_all


_hash_memo: dict[tuple, str] = {}


def source_hash() -> str:
    """Hex digest of the flags, every source and every header of ``CSRC``
    (nothing is compiled): the build directory's name, and what the
    autotuner's code fingerprint takes of the kernels.  Recomputed only
    when a file's size or modification time changes."""
    paths = [CSRC / f"{name}.cu" for name in SOURCES] + sorted(CSRC.glob("*.cuh"))
    stamp = tuple((str(p), p.stat().st_mtime_ns, p.stat().st_size) for p in paths)
    hit = _hash_memo.get(stamp)
    if hit is None:
        if len(_hash_memo) > 64:        # bound edit churn
            _hash_memo.clear()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in paths:
            h.update(path.name.encode())
            h.update(path.read_bytes())
        hit = _hash_memo[stamp] = h.hexdigest()
    return hit


def build_dir() -> Path:
    """``build/repro_torch/<hash of sources and flags>`` under the checkout."""
    root = Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch" / source_hash()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels are built from source at first use")
    return str(path)


def _start(name: str, out_dir: Path) -> tuple[subprocess.Popen, Path, Path]:
    tmp = out_dir / f"{name}.so.tmp{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out_dir / f"{name}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every missing library, one nvcc per source, all started
    together.  Returns nvcc's report (``-Xptxas -v``) per source built."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"{n}.so").exists()]
    SECONDS.clear()
    start = time.perf_counter()
    jobs = {n: _start(n, out_dir) for n in todo}
    done = {}

    def wait(name, proc):      # one thread a job: each nvcc's time is its own
        done[name] = proc.communicate()
        SECONDS[name] = time.perf_counter() - start
    waiters = [threading.Thread(target=wait, args=(n, job[0])) for n, job in jobs.items()]
    for th in waiters:
        th.start()
    for th in waiters:
        th.join()
    reports, failures = {}, []
    for name, (proc, tmp, final) in jobs.items():
        out, err = done[name]
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{err}{out}")
            tmp.unlink(missing_ok=True)
            continue
        reports[name] = err + out
        log = out_dir / f"{name}.ptxas.txt"
        log.write_text(reports[name])
        os.replace(tmp, final)
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def report(name: str) -> str:
    """nvcc's report from the build of ``csrc/<name>.cu`` ("" if unbuilt)."""
    log = build_dir() / f"{name}.ptxas.txt"
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_dir() / f"{name}.so"
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    if name == "transpose":
        lib.repro_transpose_reg.argtypes = [ptr, ptr] + [i64] * 6 + [ptr, i64, ptr]
        lib.repro_transpose_reg.restype = ctypes.c_int
    elif name == "sweep_far":
        for fn in (lib.repro_sweep_far_f32, lib.repro_sweep_far_bf16):
            fn.argtypes = [ptr, ptr] + [i64] * 17 + [ptr, ptr]
            fn.restype = ctypes.c_int
        lib.repro_sweep_far_smem.argtypes = [i64] * 10
        lib.repro_sweep_far_smem.restype = i64
    elif name == "sweep1d_warp_bf16":
        lib.repro_sweep1d_warp_bf16.argtypes = [ptr, ptr] + [i64] * 9 + [ptr, ptr, ptr]
        lib.repro_sweep1d_warp_bf16.restype = ctypes.c_int
    elif name == "sweep1d_warp":
        lib.repro_sweep1d_warp_f32.argtypes = [ptr, ptr] + [i64] * 9 + [ptr, ptr, ptr]
        lib.repro_sweep1d_warp_f32.restype = ctypes.c_int
        lib.repro_sweep1d_warp_blocks.argtypes = [i64]
        lib.repro_sweep1d_warp_blocks.restype = i64
    elif name == "sweep2d_warp_bf16":
        lib.repro_sweep2d_warp_bf16.argtypes = [ptr, ptr] + [i64] * 10 + [ptr, ptr, ptr]
        lib.repro_sweep2d_warp_bf16.restype = ctypes.c_int
    elif name == "sweep2d_warp":
        lib.repro_sweep2d_warp_f32.argtypes = [ptr, ptr] + [i64] * 10 + [ptr, ptr, ptr]
        lib.repro_sweep2d_warp_f32.restype = ctypes.c_int
        for fn in (lib.repro_sweep2d_warp_max_depth, lib.repro_sweep2d_warp_warps,
                   lib.repro_sweep2d_warp_has_depth):
            fn.restype = i64
        lib.repro_sweep2d_warp_max_depth.argtypes = [i64, i64]
        lib.repro_sweep2d_warp_has_depth.argtypes = [i64, i64, i64]
        lib.repro_sweep2d_warp_warps.argtypes = []
    elif name == "sweep3d_bf16":
        lib.repro_sweep3d_bf16.argtypes = [ptr, ptr] + [i64] * 11 + [ptr, ptr, ptr]
        lib.repro_sweep3d_bf16.restype = ctypes.c_int
    elif name == "sweep3d":
        lib.repro_sweep3d_f32.argtypes = [ptr, ptr] + [i64] * 11 + [ptr, ptr, ptr]
        lib.repro_sweep3d_f32.restype = ctypes.c_int
        lib.repro_sweep3d_max_depth.argtypes = [i64, i64]
        lib.repro_sweep3d_max_depth.restype = i64
        lib.repro_sweep3d_tile.argtypes = [i64] * 5
        lib.repro_sweep3d_tile.restype = i64
    elif name == "onestep":
        for suffix in ("f32", "bf16"):
            naive = getattr(lib, f"repro_onestep_naive_{suffix}")
            naive.argtypes = [ptr, ptr, i64, i64, ptr, ptr, ptr]
            naive.restype = ctypes.c_int
            trans = getattr(lib, f"repro_onestep_transpose_{suffix}")
            trans.argtypes = [ptr, ptr] + [i64] * 5 + [ptr, ptr, ptr]
            trans.restype = ctypes.c_int
            naive_mem = getattr(lib, f"repro_onestep_naive_mem_{suffix}")
            naive_mem.argtypes = [ptr, ptr, i64, i64, ptr, ptr]
            naive_mem.restype = ctypes.c_int
            trans_mem = getattr(lib, f"repro_onestep_transpose_mem_{suffix}")
            trans_mem.argtypes = [ptr, ptr] + [i64] * 4 + [ptr, ptr]
            trans_mem.restype = ctypes.c_int
        for fn in (lib.repro_onestep_max_reach, lib.repro_onestep_naive_max_reach,
                   lib.repro_onestep_max_taps, lib.repro_onestep_lane_taps):
            fn.argtypes = []
            fn.restype = i64
    elif name == "ssd_scan":
        lib.repro_ssd_state.argtypes = [ptr] * 6 + [i64] * 7 + [ptr, i64, ptr]
        lib.repro_ssd_out.argtypes = [ptr] * 7 + [i64] * 7 + [ptr, i64, ptr]
        for fn in (lib.repro_ssd_state, lib.repro_ssd_out):
            fn.restype = ctypes.c_int
        for fn in (lib.repro_ssd_max_chunk, lib.repro_ssd_max_state, lib.repro_ssd_chunk):
            fn.argtypes = []
            fn.restype = i64
        lib.repro_ssd_smem_bytes.argtypes = [i64] * 4
        lib.repro_ssd_smem_bytes.restype = i64
        lib.repro_ssd_tf32_check_threads.argtypes = []
        lib.repro_ssd_tf32_check_threads.restype = i64
        lib.repro_ssd_tf32_mismatches.argtypes = [ptr, ptr]
        lib.repro_ssd_tf32_mismatches.restype = ctypes.c_int
    else:
        raise ValueError(f"unknown kernel library {name!r}")


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
