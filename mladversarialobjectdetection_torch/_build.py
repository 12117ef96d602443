"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, `_build/<name>-<hash>.so`, where the hash covers the source, the
files of `csrc/` it includes and the flags; an existing library is reused. The compiler's `-Xptxas -v` report
(registers, shared memory, spills) is kept beside each library as
`<name>-<hash>.log`.

Nothing here runs at import: the CPU tests import every module of the port
on machines that have no nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _sources(path: Path):
    """path and the files of csrc/ it includes with `#include "..."`, in order."""
    text = path.read_bytes()
    yield text
    for inc in re.findall(rb'^#include "([^"]+)"', text, flags=re.M):
        yield from _sources(CSRC_DIR / inc.decode())


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed by its sources and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for text in _sources(CSRC_DIR / f"{name}.cu"):
        digest.update(text)
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every `csrc/*.cu` whose library is missing, one nvcc process
    per source, all started together; return all libraries."""
    targets = {src.stem: library_path(src.stem)
               for src in sorted(CSRC_DIR.glob("*.cu"))}
    missing = {name: out for name, out in targets.items() if not out.exists()}
    if not missing:
        return targets
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in missing.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out = missing[name]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return targets


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    return ctypes.CDLL(str(build_all()[name]))
