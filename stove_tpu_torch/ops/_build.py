"""Build and load the port's CUDA kernels: plain `nvcc` into ctypes libraries.

Every kernel source under `csrc/` is compiled for sm_90a with its shape
defines (`-DNAME=value`) into a shared library with a plain C interface,
at first use, under `build/kernels/` (git-ignored).  A library's file
name carries a hash of its source, every header in `csrc/`, the flags and
the defines, so a changed source or shape builds anew and an unchanged
one is reused.  Builds write to a temporary file and rename it into
place, so a concurrent build sees all or nothing.

`build` compiles any number of (source, defines) jobs at once, one `nvcc`
process each, all started together; `load` builds one job if needed and
loads it (each library once per process).  `BUILDS` keeps, per library,
the seconds its build took and nvcc's `-Xptxas -v` report (registers,
shared memory, spills) for whoever wants to print them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

Job = Tuple[str, Tuple[str, ...]]          # (source file in csrc/, defines)

# library path -> (build seconds, nvcc output); filled by `build`
BUILDS: Dict[str, Tuple[float, str]] = {}
_LIBS: Dict[Job, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from csrc/ at first use")
    return found


def library_path(source: str, defines: Sequence[str]) -> Path:
    """Where the library of (source, defines) lives once built."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(defines)).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(jobs: Sequence[Job]) -> List[Path]:
    """Compile every job whose library is missing, all `nvcc`s at once.

    Returns the library paths in job order; raises with nvcc's output if
    any build fails.
    """
    paths = [library_path(src, d) for src, d in jobs]
    todo = {}
    for (src, defines), path in zip(jobs, paths):
        if not path.exists() and str(path) not in todo:
            todo[str(path)] = (src, defines)
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for out, (src, defines) in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, *defines, f"-I{CSRC}", "-o", tmp,
               str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for out, tmp, cmd, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        BUILDS[out] = (seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(source: str, defines: Sequence[str],
         setup: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """Build (at first use) and load one kernel library; `setup` declares
    its functions' argument and return types once, when it is loaded.
    Later calls with the same source and defines return the loaded library
    without touching the files, so a launch pays no hashing."""
    key = (source, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build([key])[0]))
        if setup is not None:
            setup(lib)
        _LIBS[key] = lib
    return lib


def ptxas_report(path: Path) -> str:
    """The register / shared-memory / spill lines nvcc printed for a library
    built in this process ('' if it was already built)."""
    _, log = BUILDS.get(str(path), (0.0, ""))
    return " | ".join(ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln)


def check_device(*tensors) -> None:
    """Raise unless every tensor lies on one sm_90 CUDA device."""
    import torch
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("the kernel takes CUDA tensors on one device; "
                             f"got {[str(x.device) for x in tensors]}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError("the port's kernels are built for sm_90a (H100); "
                           f"this card is {torch.cuda.get_device_name(dev)}")


def stream_of(tensor) -> int:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
