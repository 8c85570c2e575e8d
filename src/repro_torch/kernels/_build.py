"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles into one shared library with a plain
``extern "C"`` launcher (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so

The library lands in ``build/`` beside this module (git-ignored), named by
a hash of its source, every shared header ``csrc/*.cuh`` and the flags, so
a changed source or header never loads a stale build; nvcc's report lies
beside it (``lib<name>-<hash>.log``), so a reused build still has one. Nothing is compiled at import time: `load` builds at first use and
`build_all` builds every source at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    """One loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float          # nvcc wall time; 0.0 when an earlier build was reused
    log: str                # nvcc's output (register and spill report)


_lock = threading.Lock()
_loaded: dict[str, Built] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels build only where the toolkit exists")


def _target(name: str, csrc: Path = CSRC,
            build_dir: Path = BUILD_DIR) -> tuple[Path, Path]:
    """The source of `name` and the library path named by its content hash.

    The hash covers ``<name>.cu``, every header ``*.cuh`` beside it (by
    name and content) and the nvcc flags.
    """
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> Built:
    _, out = _target(name)
    seconds, log = 0.0, ""
    if started is not None:
        proc, tmp, out, t0 = started
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    elif out.with_suffix(".log").exists():
        log = out.with_suffix(".log").read_text()
    built = Built(ctypes.CDLL(str(out)), out, seconds, log)
    _loaded[name] = built
    return built


def load(name: str) -> Built:
    """The built library of ``csrc/<name>.cu``, compiling it on first use."""
    with _lock:
        if name not in _loaded:
            _finish(name, _start(name))
        return _loaded[name]


def build_all() -> dict[str, Built]:
    """Build and load every ``csrc/*.cu`` with all nvcc processes in parallel."""
    with _lock:
        names = [p.stem for p in sorted(CSRC.glob("*.cu"))
                 if p.stem not in _loaded]
        started = {n: _start(n) for n in names}
        try:
            for n in names:
                _finish(n, started[n])
        finally:                        # a failed build stops the others
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
        return dict(_loaded)
