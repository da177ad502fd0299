"""Build the package's hand-written CUDA kernels with nvcc and load them.

Each kernel source under ``gdrnpp_bop2022_torch/csrc/`` exposes a plain
``extern "C"`` launcher. At first use it is compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

plus the source's own flags from ``EXTRA_FLAGS``, into
``gdrnpp_bop2022_torch/_build/`` (listed in .gitignore), keyed by a hash of
the source and all its flags, and loaded with ``ctypes``. A file with a
plain C interface builds in seconds; nothing here includes PyTorch's
headers. ``build_kernel_libraries`` starts one nvcc per missing source, all
at once. A build that fails raises: there is no fallback.

``load_host_library`` builds a host C++ source with a plain C interface
(``native/rle.cpp``, the RLE codec) the same way with ``g++`` (or $CXX)
into the same directory, keyed by a hash of the source and its flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# per-source nvcc flags, appended to NVCC_FLAGS and folded into the hash
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    # no FMA contraction, IEEE division, no flush to zero: the face packing
    # and the edge functions must round each operation as the plain PyTorch
    # version does, or pixels on a seam flip between versions
    "raster": ("-fmad=false", "-prec-div=true", "-ftz=false"),
}

GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def kernel_flags(name: str) -> Tuple[str, ...]:
    """nvcc flags of csrc/<name>.cu: the common ones, then its own."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def nvcc_command(nvcc: str, source: Path, out: Path) -> list:
    return [nvcc, *kernel_flags(Path(source).stem), "-o", str(out), str(source)]


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu goes: keyed by source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(kernel_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_kernel_libraries(names: Sequence[str]) -> None:
    """Compile every csrc/<name>.cu whose build is missing, one nvcc each,
    all started together; raise if any fails."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    jobs = []
    try:
        for name in todo:
            # build to a private name, then rename: concurrent builders
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(nvcc_command(nvcc, CSRC / f"{name}.cu", Path(tmp)),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            jobs.append((name, tmp, proc))
        failed = []
        for name, tmp, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{err}")
            else:
                os.replace(tmp, library_path(name))
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (once per source hash) and load it."""
    if name in _loaded:
        return _loaded[name]
    build_kernel_libraries([name])
    lib = ctypes.CDLL(str(library_path(name)))
    _loaded[name] = lib
    return lib


def host_library_path(source: Path) -> Path:
    """Where the g++ build of a host C++ source goes: keyed by source and flags."""
    source = Path(source)
    key = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-host-{key}.so"


def load_host_library(source: Path) -> ctypes.CDLL:
    """Compile a host C++ source with g++ (once per source hash) and load
    it; raise if the compiler fails."""
    out = host_library_path(source)
    if str(out) in _loaded:
        return _loaded[str(out)]
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *GXX_FLAGS, "-o", tmp, str(source)],
                           check=True, capture_output=True, text=True, timeout=120)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    _loaded[str(out)] = lib
    return lib
