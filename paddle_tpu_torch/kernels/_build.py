"""Build the CUDA kernels at first use and bind them through ``ctypes``.

Every ``.cu`` file under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` process per source, all started together), and the objects
are linked into one shared library with a plain C interface. The library
lands in ``_build/<hash>/``, keyed by a hash of the sources and flags, so an
unchanged tree builds once. Nothing here runs at import time: the CPU tests
import every module on a machine without ``nvcc``.

Each C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code, because a launch the CUDA runtime refuses (too many threads,
too much shared memory) never runs and a later synchronise does not report
it. The full ``ptxas -v`` log (registers, spills) is kept beside the library
as ``build.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["library", "kernel", "check", "build_info", "Counts"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD_ROOT = _HERE / "_build"
_LIB_NAME = "libpt_kernels.so"

_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3"]
_COMPILE_FLAGS = _ARCH_FLAGS + ["-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, object] = {}
_info: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "paddle_tpu_torch are built from source at first use")


def _sources():
    cu = sorted(_CSRC.glob("*.cu"))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return cu, sorted(_CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(_COMPILE_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """nvcc every source in parallel, then link; returns the ptxas log."""
    nvcc = _nvcc()
    cu, _ = _sources()
    procs = []
    for src in cu:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *_COMPILE_FLAGS, "-I", str(_CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    link = [nvcc, *_ARCH_FLAGS, "-shared", "-o", str(out_dir / _LIB_NAME),
            *[str(obj) for _s, obj, _p in procs]]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    return log


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cu, cuh = _sources()
        final = _BUILD_ROOT / _digest(cu + cuh)
        t0 = time.perf_counter()
        cached = (final / _LIB_NAME).is_file()
        if not cached:
            _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=_BUILD_ROOT))
            try:
                log = _compile(tmp)
                (tmp / "build.log").write_text(log)
                try:
                    os.replace(tmp, final)
                except OSError:  # another process finished the same build
                    if not (final / _LIB_NAME).is_file():
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        _lib = ctypes.CDLL(str(final / _LIB_NAME))
        _lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        _lib.pt_cuda_error_string.restype = ctypes.c_char_p
        log_file = final / "build.log"
        _info.update(seconds=time.perf_counter() - t0, cached=cached,
                     path=str(final / _LIB_NAME),
                     log=log_file.read_text() if log_file.is_file() else "")
        return _lib


def kernel(name: str, argtypes):
    """The C entry ``name`` with its argument types declared (``c_void_p``
    for every pointer and the stream) and an ``int`` return."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().pt_cuda_error_string(int(err)).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


class Counts:
    """Per-wrapper call counts: ``launches`` goes up by one where the
    wrapper launches its CUDA kernel and nowhere else; ``plain_calls`` where
    it takes the plain PyTorch version (CPU tensors only)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.plain_calls = 0

    def launched(self) -> None:
        with self._lock:
            self.launches += 1

    def plain(self) -> None:
        with self._lock:
            self.plain_calls += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.plain_calls = 0


def build_info() -> Dict[str, object]:
    """Seconds the last :func:`library` call took, whether it found a
    cached build, the library's path and the ``ptxas -v`` log."""
    library()
    return dict(_info)
