"""Defender weights from a checkpoint file.

Port of `load_antipatch` in `mladversarialobjectdetection_tpu/ckpt/
convert_defense.py:152-165`, its pytree branch: the `antipatch.pkl` that
either package's defender driver writes. A reference `antipatch.h5`
(keras `save_weights`) needs h5py, which the card's machine lacks, and
raises; so does `save_antipatch_h5`, which the port does not have.
"""
from __future__ import annotations

from . import io as ckpt_io

H5_NOT_PORTED = ("keras .h5 defender weights are not read by the port "
                 "(ROADMAP Queue 1 item 7, converters and orbax intake): "
                 "convert them with the JAX package's `ckpt/convert_defense.py`")


def load_antipatch(path: str):
    """The U-Net's Flax `{'params', 'batch_stats'}` variables saved at `path`
    (a pytree file, `<path>.pkl`). The JAX function's second argument, the
    template of the .h5 conversion, has no use here."""
    if str(path).endswith((".h5", ".hdf5")):
        raise NotImplementedError(f"{path}: {H5_NOT_PORTED}")
    restored = ckpt_io.load_pytree(path)
    return {"params": restored["params"],
            "batch_stats": restored.get("batch_stats", {})}
