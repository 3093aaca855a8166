"""Build a kernel source of ``csrc/`` into a shared library at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own with
``nvcc`` into ``build/kernels/`` beside the package, named by a hash of its
text, of every ``csrc/*.cuh`` header and of the flags, so an edit rebuilds it
and an unchanged source is never compiled twice. The wrappers load the result
with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import glob
import hashlib
import os
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def library_path(src: str) -> str:
    """Build output path of ``csrc/<src>``, keyed by its content, the headers'
    and the flags."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, src)] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, "lib{}_{}.so".format(stem, h.hexdigest()[:16]))


def build(src: str) -> tuple[str, str]:
    """Compile ``csrc/<src>`` if its library is missing. Returns (library
    path, nvcc's -Xptxas -v report, empty when the library was already
    there). Raises with nvcc's output when the build fails."""
    so = library_path(src)
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.tmp".format(so, os.getpid())
    cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-o", tmp, os.path.join(CSRC, src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed ({}):\n{}\n{}".format(
            " ".join(cmd), proc.stdout, proc.stderr))
    os.replace(tmp, so)
    return so, proc.stdout + proc.stderr
