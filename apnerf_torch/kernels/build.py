"""Build the CUDA sources in ``apnerf_torch/csrc`` into one shared library.

At first use, ``nvcc`` compiles every ``*.cu`` for ``sm_90a`` into a plain
C-interface library under ``apnerf_torch/_build/`` (git-ignored), named by
a hash of the sources and flags, and ``ctypes`` loads it. The sources
compile in parallel, one ``nvcc`` each, and are then linked together. A
failed build raises with nvcc's output. Only the CUDA toolkit is needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v", "-lineinfo"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types; each returns an int (a launch:
# cudaGetLastError())
SIGNATURES = {
    # q, qorder, qpos, M, pts_t, t_lo, t_hi, T, pts_per_tile, P, perm, k,
    # out_d2, out_idx, tiles_out, stream
    "knn_brute_launch": [P, P, P, I, P, P, P, I, I, I, P, I, P, P, P, P],
    # q, M, pts_t, t_lo, t_hi, T, pts_per_tile, r2, out_cnt, stream
    "knn_count_launch": [P, I, P, P, P, I, I, F, P, P],
    # q, M, pts_t, t_lo, t_hi, T, pts_per_tile, r2, k, out_d2, out_idx,
    # tiles_out, stream
    "knn_radius_launch": [P, I, P, P, P, I, I, F, I, P, P, P, P],
    # M -> K2's queries per block, K3's (and K1's) lanes per query
    "knn_count_block": [I],
    "knn_radius_lanes": [I],
    # rel, feat, w, image, b1, bl, M, K, F, n_pe, P_pad, n_layers, out,
    # stream
    "featmlp_launch": [P, P, P, P, P, P, I, I, I, I, I, I, P, P],
    # F, P_pad, n_layers, resident (out), smem_bytes (out); 0 when refused
    "featmlp_plan": [I, I, I, P, P],
    # q, idx, geo, feat, image, b1, bl, pose, live, n, K, eps, F, n_pe,
    # P_pad, n_layers, h, kth, w, stream
    "featmlp_gather_launch": [P, P, P, P, P, P, P, P, P, I, I, F, I, I, I, I,
                              P, P, P, P],
    # idx, upd, M, C, n_rows, transposed, offs, cnt, items, pinfo, partial,
    # out, stream
    "scatter_launch": [P, P, I, I, I, I, P, P, P, P, P, P, P],
    # K5's kItemRows and kHotRows
    "scatter_item_rows": [],
    "scatter_hot_rows": [],
    # q, nbr, rot, feat, image, b1, bl, S, share, kc, K, eps, F, n_pe,
    # P_pad, n_layers, h, kd2, stream
    "agg_launch": [P, P, P, P, P, P, P, I, I, I, I, F, I, I, I, I, P, P, P],
    # M, P, R, U, S, V, stream
    "procrustes_launch": [P, I, P, P, P, P, P],
    # G, U, S, V, P, dM, stream
    "procrustes_grad_launch": [P, P, P, P, I, P, P],
    # grid, unit, M, n0, n1, n2, C, vec4, out, stream
    "trilerp_launch": [P, P, I, I, I, I, I, I, P, P],
    # grid, unit, gout, M, n0, n1, n2, C, vec4, dunit, keys, stream
    "trilerp_grad_launch": [P, P, P, I, I, I, I, I, I, P, P, P],
    # unit, gout, order, keys_sorted, M, n0, n1, n2, C, c0, CG, vec4, idx,
    # upd, stream
    "trilerp_rows_launch": [P, P, P, P, I, I, I, I, I, I, I, I, P, P, P],
    # acc1, acc2, acc4, n0, n1, n2, C, c0, CG, dgrid, stream
    "trilerp_fold_launch": [P, P, P, I, I, I, I, I, I, P, P],
}

_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libapnerf_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{src.stem}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
               str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with argtypes declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
