"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, `_build/<name>-<hash>.so`, where the hash covers the source, the
files of `csrc/` it includes and the flags; an existing library is reused. The compiler's `-Xptxas -v` report
(registers, shared memory, spills) is kept beside each library as
`<name>-<hash>.log`.

`build_tfrecord_native` compiles the host-side TFRecord reader,
`csrc/tfrecord_native.c` (a CPython extension), with the host C compiler
into `_build/_tfrecord_native-<hash><EXT_SUFFIX>`; `load_tfrecord_native`
imports it once it exists (`data/tfrecord.py` reads records through it
then) and never builds it.

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
import sysconfig
from pathlib import Path
from typing import Dict, Optional

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


TFRECORD_SOURCE = CSRC_DIR / "tfrecord_native.c"
CC_FLAGS = ("-O3", "-fPIC", "-shared")


def tfrecord_native_path() -> Path:
    """Where `csrc/tfrecord_native.c` builds to, keyed by the source, the
    flags and the interpreter's headers and extension suffix."""
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    digest = hashlib.sha256(" ".join((*CC_FLAGS, include, suffix)).encode())
    digest.update(TFRECORD_SOURCE.read_bytes())
    return BUILD_DIR / f"_tfrecord_native-{digest.hexdigest()[:16]}{suffix}"


def build_tfrecord_native() -> Path:
    """Compile the native TFRecord reader with the host C compiler (`cc`)
    unless it is built; return the extension's path."""
    out = tfrecord_native_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cc = os.environ.get("CC") or shutil.which("cc") or "gcc"
    proc = subprocess.run(
        [cc, *CC_FLAGS, f"-I{sysconfig.get_paths()['include']}",
         str(TFRECORD_SOURCE), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"tfrecord_native.c build failed ({cc} exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


_TFRECORD_NATIVE = {}


def load_tfrecord_native() -> Optional[object]:
    """The built native TFRecord reader module, or None if it is not built."""
    path = tfrecord_native_path()
    if path in _TFRECORD_NATIVE:
        return _TFRECORD_NATIVE[path]
    if not path.exists():
        return None
    import importlib.machinery
    import importlib.util
    loader = importlib.machinery.ExtensionFileLoader("_tfrecord_native",
                                                     str(path))
    spec = importlib.util.spec_from_file_location("_tfrecord_native", path,
                                                  loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    _TFRECORD_NATIVE[path] = module
    return module
