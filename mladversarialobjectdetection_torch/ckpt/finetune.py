"""Fine-tune initialization from a pretrained detector checkpoint.

Port of `mladversarialobjectdetection_tpu/ckpt/finetune.py`, on Flax-named
variable trees (nested dicts of numpy arrays, what `ckpt/bridge.
torch_to_flax` gives and `ckpt/io.load_pytree` reads). Two modes:

- ``"backbone"``: restore everything EXCEPT the class / box heads, which
  keep their fresh initialization (the reference's ``--pretrained_ckpt``:
  ``restore_ckpt(..., exclude_layers=['class_net', 'optimizer',
  'box_net'])``, tf2/train.py:255-261);
- ``"trunk"``: restore everything EXCEPT the heads' final ``predict``
  layers (the TF-Hub fine-tune variant ``EfficientDetNetTrainHub``,
  tf2/train_lib.py:732-766: fine-tuning onto another ``num_classes``).

Leaves missing from the checkpoint or of another shape keep their fresh
initialization (util_keras.restore_ckpt's skip semantics,
util_keras.py:108-203). A reference TF1 checkpoint is converted through
`convert_tf.convert_tf_weights` with the mode's exclusions (JAX
finetune.py:102-117), read without TensorFlow.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from ..utils.log import get_logger

logger = get_logger(__name__)

_HEADS = ("class_net", "box_net")


def _excluded(mode: str, path: Tuple[str, ...]) -> bool:
    head = any(h in path for h in _HEADS)
    if mode == "backbone":
        return head
    if mode == "trunk":
        return head and "predict" in path
    raise ValueError(f"unknown finetune mode {mode!r} "
                     "(expected 'backbone' or 'trunk')")


def _dig(tree: Any, path: Tuple[str, ...]):
    for key in path:
        if not isinstance(tree, Mapping) or key not in tree:
            raise KeyError("/".join(path))
        tree = tree[key]
    return tree


def merge_pretrained(fresh_variables: Dict[str, Any], loaded: Dict[str, Any],
                     mode: str = "backbone") -> Dict[str, Any]:
    """Merge a loaded variables tree (nested dicts of arrays) into a fresh
    one, excluding the mode's fine-tune layers and skipping missing or
    mismatched leaves. Returns nested dicts of numpy arrays in the fresh
    tree's structure (keys sorted, as JAX's tree functions rebuild them)."""
    counts = {"restored": 0, "skipped": 0}

    def merge(collection: str, tree: Mapping, path: Tuple[str, ...]):
        if isinstance(tree, Mapping):
            return {k: merge(collection, tree[k], path + (k,))
                    for k in sorted(tree)}
        fresh = np.asarray(tree)
        if _excluded(mode, path):
            return fresh
        name = f"{collection}/{'/'.join(path)}"
        try:
            arr = np.asarray(_dig(loaded.get(collection, {}), path))
        except KeyError:
            logger.info(f"finetune: no {name} in checkpoint, keeping fresh init")
            counts["skipped"] += 1
            return fresh
        if arr.shape != fresh.shape:
            logger.info(f"finetune: shape mismatch {name} ckpt {arr.shape} vs "
                        f"model {fresh.shape}, keeping fresh init")
            counts["skipped"] += 1
            return fresh
        counts["restored"] += 1
        return arr.astype(fresh.dtype)

    out = {collection: merge(collection, tree, ())
           for collection, tree in fresh_variables.items()}
    logger.info(f"finetune({mode}): restored {counts['restored']} leaves, "
                f"kept {counts['skipped']} fresh (+ excluded head layers)")
    return out


def restore_pretrained(fresh_variables: Dict[str, Any], ckpt_path: str,
                       config=None, spec=None, *, mode: str = "backbone"
                       ) -> Dict[str, Any]:
    """Restore `ckpt_path` (a pytree file `<ckpt_path>.pkl`, an orbax
    directory, a reference TF1 checkpoint prefix or directory, or a release
    tarball) into `fresh_variables` under the mode's exclude rules;
    `config` and `spec` serve the TF1 branch."""
    from . import convert_tf
    from . import io as ckpt_io

    _excluded(mode, ())  # validate the mode before any IO
    tf_prefix = convert_tf.find_tf_checkpoint(ckpt_path)
    if tf_prefix:
        variables = convert_tf.convert_tf_weights(
            convert_tf.load_tf_checkpoint(tf_prefix), config, spec,
            fresh_variables, skip=lambda coll, path: _excluded(mode, path),
            strict=False)
        logger.info(f"finetune({mode}): from TF checkpoint {tf_prefix}")
        return variables
    loaded = ckpt_io.load_pytree(ckpt_path)
    logger.info(f"finetune({mode}): from native checkpoint {ckpt_path}")
    return merge_pretrained(fresh_variables, loaded, mode)
