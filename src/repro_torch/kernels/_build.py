"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc`` for Hopper (``sm_90a``) into its own shared library, which is
loaded with ``ctypes``.  No PyTorch header is included, so a build takes
seconds, not minutes.  Libraries land in ``build/repro_torch/`` at the root
of the checkout (``$REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash
of the source and the flags: an edited source builds anew, an unchanged one
is reused.  Stale sources build in parallel, one ``nvcc`` each.  A failed
build raises with the compiler's output; nothing falls back.

Nothing here runs at import time: the first CUDA call of a kernel wrapper
(or an explicit :func:`build`) compiles.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# Guards the wrappers' launch counters: kernels launch from more than one
# thread (a server's dispatcher thread beside the caller's), and a bare
# ``+= 1`` on a module global can lose a count.
COUNT_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of repro_torch are built from source")
    return found


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every stale source among ``names`` (default: all) in
    parallel.  Returns ``{name: compiler log}`` for the sources it compiled
    (``-Xptxas=-v`` puts registers, shared memory and spills there)."""
    names = sources() if names is None else list(names)
    stale = {n: _target(n) for n in names if not _target(n).exists()}
    if not stale:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    for name, target in stale.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, target, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
