"""TF1 checkpoint detection (the intake itself is not ported).

Port of the pure-Python part of `mladversarialobjectdetection_tpu/ckpt/
convert_tf.py`: `find_tf_checkpoint` (convert_tf.py:65-106) and
`extract_ckpt_tarball` (:29-62), copied as they are, so that the drivers
and `Detector` recognise a reference TF checkpoint (a prefix, a directory
or a tarball) before they read a path as a pytree file. Reading and
converting one needs TensorFlow, which the card's machine lacks:
`load_tf_checkpoint` raises.
"""
from __future__ import annotations

import re

TF_NOT_PORTED = ("TF checkpoints are not read by the port (ROADMAP Queue 1 "
                 "item 7, converters and orbax intake): convert with the JAX "
                 "package (`ckpt/convert_tf.py`) and save a pytree file")


def extract_ckpt_tarball(path: str) -> str:
    """Extract a checkpoint tarball next to itself (once, idempotent) and
    return the directory holding the checkpoint files.

    This is the local-artifact half of the reference's download-and-untar
    flow (util.py:76-88: GCS `.tar.gz` -> `tarfile.extractall`): a
    pre-downloaded `efficientdet-lite4.tgz` passed as `--victim-ckpt`
    works with zero network access. GCS release tarballs wrap the
    checkpoint in a single `<model-name>/` directory; that wrapper is
    resolved here so callers always get the dir with `checkpoint`/`.index`
    files in it.
    """
    import os
    import tarfile

    dest = path + ".extracted"
    if not os.path.isdir(dest):
        tmp = dest + f".tmp{os.getpid()}"
        with tarfile.open(path) as tar:
            tar.extractall(tmp, filter="data")
        try:
            os.replace(tmp, dest)  # atomic: concurrent extractors race safely
        except OSError:
            import shutil
            if os.path.isdir(dest):  # somebody else won the race
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                raise
    entries = sorted(os.listdir(dest))
    if len(entries) == 1 and os.path.isdir(os.path.join(dest, entries[0])):
        return os.path.join(dest, entries[0])
    return dest


def find_tf_checkpoint(path: str):
    """Return the TF checkpoint prefix if `path` points at a TF1
    name-based checkpoint, else None.

    Accepts: a checkpoint prefix (`.../model` with `model.index` beside
    it), a directory containing either a `checkpoint` state file
    (reference GCS tarball layout, util.py:76-88) or `*.index` files, or
    a checkpoint **tarball** (`.tgz`/`.tar.gz`/`.tar` — the exact
    artifact the reference downloads; extracted on first use beside the
    file). Lets the drivers take the reference's downloaded checkpoints
    directly (auto-converting on load) without a separate conversion
    run. No TF import needed for the detection itself.
    """
    import glob
    import os

    if os.path.isfile(path) and path.endswith((".tgz", ".tar.gz", ".tar")):
        return find_tf_checkpoint(extract_ckpt_tarball(path))
    if os.path.isfile(path + ".index"):
        return path
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if os.path.isfile(state):
            m = re.search(r'model_checkpoint_path:\s*"([^"]+)"',
                          open(state).read())
            if m:
                p = m.group(1)
                if not os.path.isabs(p):
                    p = os.path.join(path, p)
                if os.path.isfile(p + ".index"):
                    return p
        def step_key(p):
            # numeric step suffix (model.ckpt-10 > model.ckpt-9); fall back
            # to lexicographic only when no number is present
            m = re.search(r"(\d+)\.index$", p)
            return (1, int(m.group(1)), p) if m else (0, 0, p)

        idx = sorted(glob.glob(os.path.join(path, "*.index")), key=step_key)
        if idx:
            return idx[-1][:-len(".index")]
    return None


def load_tf_checkpoint(path: str):
    """Not ported: needs TensorFlow (JAX convert_tf.py:109)."""
    raise NotImplementedError(f"{path}: {TF_NOT_PORTED}")
