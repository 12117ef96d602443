"""TF checkpoint -> Flax-layout variables for EfficientDet, without TensorFlow.

Port of `mladversarialobjectdetection_tpu/ckpt/convert_tf.py` (reference
tf2/util_keras.py:108-203, `restore_ckpt`): the automl variable naming
scheme (per-block auto-numbered convs and BatchNorms, per-level head
BatchNorms `class-%d-bn-%d`, the fnode suffixes `op_after_combine{n}` /
`resample_{i}_{o}_{n}`) and the EMA shadows
(`<var>/ExponentialMovingAverage`, preferred where present).

- `extract_ckpt_tarball` and `find_tf_checkpoint` are the JAX module's
  (:29-106), copied as they are: a prefix, a directory or a release tarball.
- `load_tf_checkpoint` reads the bundle with the port's own reader
  (`ckpt/tf_bundle.py`), where JAX calls `tf.train.load_checkpoint`.
- `_NameMapper` and `convert_tf_weights` (:126-305) work on the Flax-layout
  variables, nested dicts of numpy arrays, that `ckpt/bridge.torch_to_flax`
  gives; the port's net takes the result through `bridge.
  load_flax_variables`. The tree is walked in JAX's order (sorted keys),
  so the warnings and the summary are JAX's.
- `convert_checkpoint` and the CLI write the port's `<out>.pkl`
  (`ckpt/io.save_pytree`), which both packages read:

    python -m mladversarialobjectdetection_torch.ckpt.convert_tf \\
        --ckpt efficientdet-lite4.tgz --model efficientdet-lite4 --out lite4

Weight layout (Flax's, as the JAX module): conv kernels HWIO as TF's; a
depthwise [kh, kw, C, 1] -> [kh, kw, 1, C]; separable convs' depthwise_kernel
-> dw/kernel, pointwise_kernel -> pw/kernel, bias -> pw/bias; BatchNorm
gamma / beta -> scale / bias, moving_mean / moving_variance -> mean / var;
the fnode fusion scalars WSM, WSM_1, ... -> one stacked [n] vector.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, Mapping, Tuple

import numpy as np

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


def load_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a TF checkpoint into {var_name: ndarray} (no ':0' suffixes).

    Targets TF1 name-based checkpoints, the format of the official
    EfficientDet releases the reference downloads (util.py:76-88); their keys
    are the variable names plus optional `/ExponentialMovingAverage`
    shadows. TF2 object-based checkpoints (`.../.ATTRIBUTES/VARIABLE_VALUE`
    keys) are not mapped. Read by `ckpt/tf_bundle.read_bundle`, no TF."""
    from .tf_bundle import read_bundle
    return read_bundle(path)


def tf_weights_from_keras_model(model) -> Dict[str, np.ndarray]:
    """{var_name (no :0): ndarray} from a live keras model (for goldens)."""
    return {w.name.split(":")[0]: np.asarray(w) for w in model.weights}


def _dw_to_flax(kernel: np.ndarray) -> np.ndarray:
    """[kh, kw, C, mult=1] -> [kh, kw, 1, C]."""
    kh, kw, c, m = kernel.shape
    assert m == 1, f"depth multiplier {m} unsupported"
    return kernel.transpose(0, 1, 3, 2)


class _NameMapper:
    """flax path -> (tf name, transform) for one EfficientDet config."""

    def __init__(self, config, spec):
        self.backbone_prefix = config.backbone_name
        self.spec = spec
        self.min_level = config.min_level
        self.num_levels = config.max_level - config.min_level + 1
        self.separable = config.separable_conv

    def __call__(self, collection: str, path: tuple
                 ) -> tuple[str, Callable[[np.ndarray], np.ndarray]]:
        parts = list(path)
        ident = lambda x: x
        leaf = parts[-1]

        # ---- BatchNorm leaves --------------------------------------------
        bn_leaf = {"scale": "gamma", "bias": "beta",
                   "mean": "moving_mean", "var": "moving_variance"}
        is_bn = len(parts) >= 2 and parts[-2] == "bn"

        if parts[0] == "backbone":
            bb = self.backbone_prefix
            if parts[1] == "stem_conv":
                return f"{bb}/stem/conv2d/kernel", ident
            if parts[1] == "stem_bn":
                return f"{bb}/stem/tpu_batch_normalization/{bn_leaf[leaf]}", ident
            m = re.match(r"blocks_(\d+)", parts[1])
            if m:
                idx = int(m.group(1))
                block = f"{bb}/blocks_{idx}"
                has_expand = self.spec.backbone.blocks[idx].expand_ratio != 1
                sub = parts[2]
                if sub == "expand_conv":
                    return f"{block}/conv2d/kernel", ident
                if sub == "project_conv":
                    n = "conv2d_1" if has_expand else "conv2d"
                    return f"{block}/{n}/kernel", ident
                if sub == "depthwise_conv":
                    return f"{block}/depthwise_conv2d/depthwise_kernel", _dw_to_flax
                if sub in ("bn0", "bn1", "bn2"):
                    order = (["bn0", "bn1", "bn2"] if has_expand
                             else ["bn1", "bn2"])
                    k = order.index(sub)
                    n = ("tpu_batch_normalization" if k == 0
                         else f"tpu_batch_normalization_{k}")
                    return f"{block}/{n}/{bn_leaf[leaf]}", ident
                if sub == "se":
                    which = "conv2d" if parts[3] == "reduce" else "conv2d_1"
                    return f"{block}/se/{which}/{leaf}", ident
            raise KeyError(f"unmapped backbone path {path}")

        if re.match(r"resample_p\d+", parts[0]):
            if parts[1] == "conv2d":
                return f"{parts[0]}/conv2d/{leaf}", ident
            if is_bn:
                return f"{parts[0]}/bn/{bn_leaf[leaf]}", ident

        if parts[0] == "fpn_cells":
            cell, fnode = parts[1], parts[2]  # cell_R, fnodeK
            k = int(fnode.replace("fnode", ""))
            prefix = f"fpn_cells/{cell}/{fnode}"
            n_feats = self.num_levels + k
            sub = parts[3]
            if sub == "conv_dw":
                return (f"{prefix}/op_after_combine{n_feats}/conv/"
                        f"depthwise_kernel", _dw_to_flax)
            if sub == "conv_pw":
                n = "pointwise_kernel" if leaf == "kernel" else "bias"
                return f"{prefix}/op_after_combine{n_feats}/conv/{n}", ident
            if sub == "conv":
                return f"{prefix}/op_after_combine{n_feats}/conv/{leaf}", ident
            if sub == "bn":
                return (f"{prefix}/op_after_combine{n_feats}/bn/"
                        f"{bn_leaf[leaf]}", ident)
            if sub == "WSM":
                return f"{prefix}/WSM", ident  # handled specially (stacked)
            m = re.match(r"resample_(\d+)_(\d+)", sub)
            if m:
                rs = f"{prefix}/resample_{m.group(1)}_{m.group(2)}_{n_feats}"
                if parts[4] == "conv2d":
                    return f"{rs}/conv2d/{leaf}", ident
                return f"{rs}/bn/{bn_leaf[leaf]}", ident
            raise KeyError(f"unmapped fpn path {path}")

        if parts[0] in ("class_net", "box_net"):
            head = "class" if parts[0] == "class_net" else "box"
            sub = parts[1]
            m = re.match(r"conv_(\d+)", sub)
            if m or sub == "predict":
                layer = (f"{head}-{m.group(1)}" if m else f"{head}-predict")
                if self.separable:
                    if parts[2] == "dw":
                        return (f"{parts[0]}/{layer}/depthwise_kernel",
                                _dw_to_flax)
                    n = "pointwise_kernel" if leaf == "kernel" else "bias"
                    return f"{parts[0]}/{layer}/{n}", ident
                return f"{parts[0]}/{layer}/{leaf}", ident
            m = re.match(r"bn_(\d+)_l(\d+)", sub)
            if m:
                level = self.min_level + int(m.group(2))
                return (f"{parts[0]}/{head}-{m.group(1)}-bn-{level}/"
                        f"{bn_leaf[leaf]}", ident)
        raise KeyError(f"unmapped path {collection}/{path}")


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in JAX's flattening order: dict keys sorted."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    else:
        yield path, tree


def _nest(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def convert_tf_weights(tf_weights: Dict[str, np.ndarray], config, spec,
                       flax_variables, *, prefer_ema: bool = True,
                       skip=None, strict: bool = True):
    """Fill a Flax-layout variables tree (nested dicts of arrays, e.g.
    `bridge.torch_to_flax(net)`) from TF weights. Raises on any miss.

    `skip(collection, path) -> bool` keeps the fresh leaf untouched (the
    fine-tune exclude_layers mechanism, reference tf2/train.py:255-261);
    `strict=False` additionally keeps fresh leaves on missing TF names or
    shape mismatches instead of raising, the skip semantics of
    util_keras.restore_ckpt (util_keras.py:108-203). Each non-strict skip
    is logged with its cause and a restored / skipped summary is emitted,
    as the JAX function does (:250-305). Returns nested dicts of numpy
    arrays in the template's dtypes."""
    from ..utils.log import get_logger
    logger = get_logger(__name__)

    mapper = _NameMapper(config, spec)

    def lookup(name: str) -> np.ndarray:
        if prefer_ema and f"{name}/ExponentialMovingAverage" in tf_weights:
            return tf_weights[f"{name}/ExponentialMovingAverage"]
        return tf_weights[name]

    out = {}
    restored = 0
    skipped = []
    for collection, tree in flax_variables.items():
        new_leaves = []
        for path, leaf in _leaves(tree):
            leaf = np.asarray(leaf)
            if skip is not None and skip(collection, path):
                new_leaves.append((path, leaf))
                continue
            try:
                tf_name, transform = mapper(collection, path)
                if path[-1] == "WSM":
                    n = leaf.shape[0] if leaf.ndim >= 1 else 1
                    vals = [lookup(tf_name if i == 0 else f"{tf_name}_{i}")
                            for i in range(n)]
                    arr = np.stack(vals).reshape(leaf.shape)
                else:
                    arr = transform(np.asarray(lookup(tf_name)))
                if arr.shape != leaf.shape:
                    raise ValueError(
                        f"shape mismatch {collection}/{'/'.join(path)}: "
                        f"tf {arr.shape} vs flax {leaf.shape} ({tf_name})")
            except (KeyError, ValueError) as e:
                if strict:
                    raise
                skipped.append((collection, "/".join(path),
                                f"{type(e).__name__}: {e}"))
                logger.warning(
                    f"convert_tf_weights: keeping fresh init for "
                    f"{collection}/{'/'.join(path)} ({type(e).__name__}: {e})")
                new_leaves.append((path, leaf))
                continue
            restored += 1
            new_leaves.append((path, arr.astype(leaf.dtype)))
        out[collection] = _nest(new_leaves)
    if not strict:
        logger.info(f"convert_tf_weights: restored {restored} leaves, "
                    f"skipped {len(skipped)} (kept fresh init)")
    return out


def convert_checkpoint(ckpt_path: str, model_name: str, out_path: str,
                       image_size=None) -> str:
    """CLI: TF checkpoint (a prefix, a directory or a release tarball) ->
    the pytree file `<out_path>.pkl` (JAX :308-331, which writes an orbax
    directory where orbax is installed); returns the file written."""
    import torch

    from .. import config as config_lib
    from ..models.efficientdet import EfficientDetNet, spec_from_config
    from ..models.init import init_weights
    from . import bridge
    from . import io as ckpt_io

    config = config_lib.get_efficientdet_config(model_name)
    if image_size is not None:
        config.image_size = image_size
    spec = spec_from_config(config)
    prefix = find_tf_checkpoint(ckpt_path) or ckpt_path
    net = EfficientDetNet(spec)
    init_weights(net, torch.Generator().manual_seed(0))
    converted = convert_tf_weights(load_tf_checkpoint(prefix), config, spec,
                                   bridge.torch_to_flax(net))
    return ckpt_io.save_pytree(out_path, converted)


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="TF ckpt -> Flax-layout pytree file")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--model", default="efficientdet-lite4")
    p.add_argument("--out", required=True)
    p.add_argument("--image-size", type=int, default=None)
    a = p.parse_args()
    print(convert_checkpoint(a.ckpt, a.model, a.out, a.image_size))
