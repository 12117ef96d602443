"""Reference defender (attention U-Net) weights in keras `.h5` form.

Port of `mladversarialobjectdetection_tpu/ckpt/convert_defense.py`, on
Flax-layout variables (nested dicts of numpy arrays; the port's U-Net gives
and takes them through `ckpt/bridge.py`). The reference trains
`generator.PatchNeutralizer` (a tf.keras model, generator.py:17-96) and
checkpoints it as `antipatch.h5` inside `patch_{epoch}_{val_loss}` dirs
(attack_detection.py:311-318); the demos restore it with `load_weights`
(demo_v2.py:226). This module maps those weights onto the U-Net's
variables (`load_antipatch_h5`, `convert_unet_weights`, `load_antipatch`)
and writes them back in that format (`save_antipatch_h5`), so either side's
defender loads into the other. h5py is imported only where a file is read
or written: the card's machine has none.

Layer correspondence (generator.py -> models/unet.py):
  conv{i}/cnv{j}, bn{j}            -> params.conv{i}.cnv{j}/bn{j}
  conv4 (bottleneck)               -> params.conv4.*
  deconv{i}/cnv  (Conv2DTranspose) -> params.deconv{i}.cnv  [see below]
  deconv{i}/attention/{cnv1,bn1,cnv2,bn2,conv3,bn3}
                                   -> params.deconv{i}.attention.*
  deconv{i}/convblock/{cnv1,bn1,cnv2,bn2}
                                   -> params.deconv{i}.convblock.*
  patch_neutralizer/output         -> params.output

Tensor transforms:
  - Conv2D kernels are HWIO in both frameworks: copied as-is.
  - Conv2DTranspose: keras stores (kh, kw, out, in) and computes the
    gradient-of-conv; Flax `nn.ConvTranspose` (transpose_kernel=False)
    computes a fractionally-strided conv, so the keras kernel is spatially
    flipped AND channel-transposed: W[::-1, ::-1].T(2,3).
  - BatchNorm: gamma/beta -> scale/bias (params); moving_mean /
    moving_variance -> mean/var (batch_stats), keras epsilon 1e-3.

Keras variable names concatenate every nesting level's `.name`, and the
reference gives sublayers parent-prefixed names, so segments double:
`deconv0/deconv0/attention/deconv0/attention/cnv1/kernel:0`
(`_keras_name`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _keras_name(path_segments, var_name: str) -> str:
    """Flax param path -> full keras weight name (without ':0')."""
    segs = list(path_segments)
    if segs[0] == "output":
        return f"patch_neutralizer/output/{var_name}"
    block = segs[0]                      # conv{i} / deconv{i}
    if len(segs) == 1:
        raise KeyError(segs)
    if len(segs) == 2:                   # conv{i}/cnv{j}|bn{j}, deconv{i}/cnv
        return f"{block}/{block}/{segs[1]}/{var_name}"
    # deconv{i}/(attention|convblock)/leaf
    inner = f"{block}/{segs[1]}"
    return f"{block}/{inner}/{inner}/{segs[2]}/{var_name}"


_VAR_MAP = {
    # (flax collection, flax leaf) -> keras var name
    ("params", "kernel"): "kernel",
    ("params", "bias"): "bias",
    ("params", "scale"): "gamma",
    ("batch_stats", "mean"): "moving_mean",
    ("batch_stats", "var"): "moving_variance",
}


def keras_unet_weights(model) -> Dict[str, np.ndarray]:
    """{full_name: ndarray} from a live keras PatchNeutralizer."""
    out = {}
    for w, val in zip(model.weights, model.get_weights()):
        name = w.name
        if name.endswith(":0"):
            name = name[:-2]
        out[name] = np.asarray(val)
    return out


def load_antipatch_h5(path: str) -> Dict[str, np.ndarray]:
    """Read a reference `antipatch.h5` (keras save_weights format) into
    {full_name: ndarray} without needing TF installed."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in root.attrs.get("layer_names", list(root))]
        for lname in layer_names:
            g = root[lname]
            weight_names = [n.decode() if isinstance(n, bytes) else n
                            for n in g.attrs.get("weight_names", [])]
            for wname in weight_names:
                name = wname[:-2] if wname.endswith(":0") else wname
                out[name] = np.asarray(g[wname])
    return out


def convert_unet_weights(weights: Dict[str, np.ndarray], variables):
    """Map reference U-Net weights onto a Flax-layout variable tree.

    Args:
      weights: {keras_full_name: ndarray} (live model or antipatch.h5).
      variables: template {'params': ..., 'batch_stats': ...}, nested dicts
        of arrays (the port's U-Net through `bridge.torch_to_flax`, or
        JAX's `PatchNeutralizer().init(...)`): defines the target structure.

    Returns a new variables dict of numpy arrays in the template's dtypes.
    Raises KeyError on any missing weight and ValueError on any shape
    mismatch or unconsumed weight (the load is all-or-nothing: partial
    restores silently wreck parity)."""
    used = set()

    def build(path, leaf):
        collection = path[0]
        segs = list(path[1:-1])
        flax_var = path[-1]
        # the bn bias lives under params like conv biases; disambiguate by
        # sibling: BN modules have a 'scale' leaf, convs have 'kernel'
        if flax_var == "bias" and segs and segs[-1].startswith("bn"):
            keras_var = "beta"
        else:
            keras_var = _VAR_MAP[(collection, flax_var)]
        name = _keras_name(segs, keras_var)
        if name not in weights:
            raise KeyError(f"reference weights missing {name} "
                           f"(for flax {'/'.join(segs)}/{flax_var})")
        val = np.asarray(weights[name])
        if flax_var == "kernel" and segs[-1] == "cnv" and \
                segs[0].startswith("deconv"):
            # Conv2DTranspose: (kh, kw, out, in) -> flipped (kh, kw, in, out)
            val = np.transpose(val[::-1, ::-1], (0, 1, 3, 2))
        leaf = np.asarray(leaf)
        if tuple(val.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: reference "
                             f"{val.shape} vs ours {leaf.shape}")
        used.add(name)
        return np.asarray(val, leaf.dtype)

    def walk(tree, path):
        if isinstance(tree, Mapping):
            return {k: walk(v, path + (k,)) for k, v in sorted(tree.items())}
        return build(path, tree)

    converted = walk(variables, ())
    unused = set(weights) - used
    if unused:
        raise ValueError(f"unconsumed reference weights: {sorted(unused)[:5]}"
                         f" (+{max(0, len(unused) - 5)} more)")
    return converted


def load_antipatch(path: str, variables=None):
    """Restore defender weights from either format:

    - a reference `antipatch.h5` (keras save_weights), onto the structure of
      `variables` (when None, the port's default U-Net's, n_filters 8), or
    - a pytree file (`<path>.pkl`) or orbax directory (ckpt/io.py), whose
      structure is its own.

    Returns the Flax `{'params', 'batch_stats'}` variables."""
    if str(path).endswith((".h5", ".hdf5")):
        if variables is None:
            from ..models.unet import PatchNeutralizer
            from . import bridge
            variables = bridge.torch_to_flax(PatchNeutralizer())
        return convert_unet_weights(load_antipatch_h5(path), variables)
    from . import io as ckpt_io
    restored = ckpt_io.load_pytree(path)
    return {"params": restored["params"],
            "batch_stats": restored.get("batch_stats", {})}


def _h5_weight_order():
    """Per-layer keras weight order (trainables in creation order, then BN
    moving stats) exactly as tf.keras save_weights emits for the reference
    PatchNeutralizer — verified against a reference-written antipatch.h5."""
    def conv_block(prefix):
        train, stats = [], []
        for j in (1, 2):
            train += [(f"{prefix}/cnv{j}/kernel", ("params", f"cnv{j}",
                                                  "kernel")),
                      (f"{prefix}/cnv{j}/bias", ("params", f"cnv{j}",
                                                 "bias")),
                      (f"{prefix}/bn{j}/gamma", ("params", f"bn{j}",
                                                 "scale")),
                      (f"{prefix}/bn{j}/beta", ("params", f"bn{j}", "bias"))]
            stats += [(f"{prefix}/bn{j}/moving_mean",
                       ("batch_stats", f"bn{j}", "mean")),
                      (f"{prefix}/bn{j}/moving_variance",
                       ("batch_stats", f"bn{j}", "var"))]
        return train, stats

    layers = {}
    for i in range(5):
        name = f"conv{i}"
        train, stats = conv_block(f"{name}/{name}")
        layers[name] = [(n, (t[0], name) + tuple(t[1:]))
                        for n, t in train + stats]
    for i in range(4):
        name = f"deconv{i}"
        pre = f"{name}/{name}"
        train = [(f"{pre}/cnv/kernel", ("params", name, "cnv", "kernel")),
                 (f"{pre}/cnv/bias", ("params", name, "cnv", "bias"))]
        stats = []
        att = f"{pre}/attention/{name}/attention"
        for ln, fx in (("cnv1", "cnv1"), ("bn1", "bn1"), ("cnv2", "cnv2"),
                       ("bn2", "bn2"), ("conv3", "conv3"), ("bn3", "bn3")):
            if ln.startswith("cnv") or ln.startswith("conv"):
                train += [(f"{att}/{ln}/kernel",
                           ("params", name, "attention", fx, "kernel")),
                          (f"{att}/{ln}/bias",
                           ("params", name, "attention", fx, "bias"))]
            else:
                train += [(f"{att}/{ln}/gamma",
                           ("params", name, "attention", fx, "scale")),
                          (f"{att}/{ln}/beta",
                           ("params", name, "attention", fx, "bias"))]
                stats += [(f"{att}/{ln}/moving_mean",
                           ("batch_stats", name, "attention", fx, "mean")),
                          (f"{att}/{ln}/moving_variance",
                           ("batch_stats", name, "attention", fx, "var"))]
        cb = f"{pre}/convblock/{name}/convblock"
        for j in (1, 2):
            train += [(f"{cb}/cnv{j}/kernel",
                       ("params", name, "convblock", f"cnv{j}", "kernel")),
                      (f"{cb}/cnv{j}/bias",
                       ("params", name, "convblock", f"cnv{j}", "bias")),
                      (f"{cb}/bn{j}/gamma",
                       ("params", name, "convblock", f"bn{j}", "scale")),
                      (f"{cb}/bn{j}/beta",
                       ("params", name, "convblock", f"bn{j}", "bias"))]
            stats += [(f"{cb}/bn{j}/moving_mean",
                       ("batch_stats", name, "convblock", f"bn{j}", "mean")),
                      (f"{cb}/bn{j}/moving_variance",
                       ("batch_stats", name, "convblock", f"bn{j}", "var"))]
        layers[name] = train + stats
    layers["patch_neutralizer/output"] = [
        ("patch_neutralizer/output/kernel", ("params", "output", "kernel")),
        ("patch_neutralizer/output/bias", ("params", "output", "bias"))]
    return layers


def save_antipatch_h5(variables, path: str) -> None:
    """Write our defender weights as a reference-format `antipatch.h5`.

    The inverse of load_antipatch_h5: a file written here loads into the
    reference `generator.PatchNeutralizer` via keras `load_weights`
    (attack_detection.py:54-55), so defenders trained in this framework
    are consumable by the reference demos. Layout (layer_names /
    weight_names attrs, per-layer weight order) matches tf.keras's legacy
    h5 writer bit-for-bit in structure."""
    import h5py

    def get(tree, p):
        for k in p:
            tree = tree[k]
        return np.asarray(tree, np.float32)

    layers = _h5_weight_order()
    with h5py.File(path, "w") as f:
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        f.attrs["keras_version"] = np.bytes_(b"2.21.0")
        f.attrs["layer_names"] = np.array(
            [np.bytes_(n.encode()) for n in layers])
        for lname, weights in layers.items():
            g = f.create_group(lname) if lname not in f else f[lname]
            names = []
            for wname, fpath in weights:
                val = get(variables, fpath)
                if (fpath[-1] == "kernel" and fpath[-2] == "cnv"
                        and fpath[1].startswith("deconv")):
                    # flax ConvTranspose -> keras Conv2DTranspose kernel
                    val = np.transpose(val, (0, 1, 3, 2))[::-1, ::-1]
                g.create_dataset(f"{wname}:0", data=val)
                names.append(np.bytes_(f"{wname}:0".encode()))
            g.attrs["weight_names"] = np.array(names)
