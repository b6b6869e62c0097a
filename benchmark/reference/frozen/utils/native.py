"""The port's host-side C++ libraries (``apnerf_torch/native/*.cpp``):
built with ``g++`` at first use into ``apnerf_torch/_build/`` (git-ignored),
named by a hash of the source and flags, and loaded with ``ctypes``. A
failed build raises: there is no silent fallback."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = PKG / "native"
BUILD_DIR = PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]


def build_cxx(source: str, stem: str) -> ctypes.CDLL:
    """Build ``native/<source>`` (once per source and flags) as
    ``_build/lib<stem>_<hash>.so`` and load it."""
    src = NATIVE_DIR / source
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{stem}_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {src.name} failed:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
