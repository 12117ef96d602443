"""Weight bridge: Flax `{'params', 'batch_stats'}` variables <-> torch state_dict.

Reads the nested mapping of arrays that the JAX package's detector or U-Net
holds, or that `mladversarialobjectdetection_tpu/ckpt/io.py:load_pytree`
restores, as plain arrays (anything `np.asarray` accepts), so this module
needs no JAX; `torch_to_flax` writes such a mapping of numpy arrays back.

The port's module names mirror Flax's, so the mapping is a rename:

- path segments join with `.`;
- conv `kernel` HWIO -> `weight` OIHW (a depthwise `[k, k, 1, C]` becomes
  `[C, 1, k, k]`; a Flax `ConvTranspose` kernel `[3, 3, in, out]` too, which
  `models/unet.ConvTranspose` turns into torch's transposed form itself);
- BatchNorm `scale`/`bias` (params) and `mean`/`var` (batch_stats) ->
  `weight`/`bias`/`running_mean`/`running_var`. The detector's Flax wrapper
  nests `nn.BatchNorm` as an inner `bn`, which the port's `BatchNorm` does
  not, so that segment is dropped; the U-Net's `bn1`..`bn3` are bare
  `nn.BatchNorm`s;
- `WSM` fusion weights and conv `bias` keep their names.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models.efficientnet import BatchNorm

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
_BN_FLAX = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _torch_key(collection: str, path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    if mods and mods[-1] == "bn" and leaf in _BN_LEAVES:
        return ".".join(mods[:-1] + [_BN_LEAVES[leaf]])
    if (collection, leaf) in (("params", "scale"), ("batch_stats", "mean"),
                              ("batch_stats", "var")):
        return ".".join(mods + [_BN_LEAVES[leaf]])
    if collection == "params" and leaf == "kernel":
        return ".".join(mods + ["weight"])
    if collection == "params" and leaf in ("bias", "WSM"):
        return ".".join(mods + [leaf])
    raise KeyError(f"unknown Flax variable {collection}/{'/'.join(path)}")


def flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert Flax variables into a torch state_dict (CPU, fp32)."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown Flax collections {sorted(unknown)}")
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            key = _torch_key(collection, path)
            arr = np.array(leaf, dtype=np.float32)  # a writable copy
            if path[-1] == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{key}: expected an HWIO kernel, "
                                     f"got shape {arr.shape}")
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if key in state:
                raise KeyError(f"two Flax variables map to {key}")
            state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load Flax variables into `module`; raise on any unmatched key or shape."""
    state = flax_to_torch(variables)
    expected = module.state_dict()
    missing = sorted(set(expected) - set(state))
    unused = sorted(set(state) - set(expected))
    if missing or unused:
        raise KeyError(f"Flax variables do not match the module: "
                       f"missing {missing[:8]} ({len(missing)}), "
                       f"unused {unused[:8]} ({len(unused)})")
    for key, value in state.items():
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: Flax shape {tuple(value.shape)} vs "
                             f"module shape {tuple(expected[key].shape)}")
    module.load_state_dict(state, strict=True)
    return module


def _flax_name(subs: Mapping[str, nn.Module], key: str, ndim: int
               ) -> Tuple[str, list, str]:
    """(collection, module path, leaf name) of the Flax variable that the
    state_dict entry `key` of a tensor of `ndim` dimensions maps to."""
    owner, _, leaf = key.rpartition(".")
    sub = subs[owner]
    path = owner.split(".") if owner else []
    if isinstance(sub, BatchNorm) and leaf in _BN_FLAX:
        collection, name = _BN_FLAX[leaf]
        if getattr(sub, "FLAX_INNER_BN", True):
            path = path + ["bn"]
        return collection, path, name
    if leaf == "weight" and ndim == 4:
        return "params", path, "kernel"
    if leaf in ("bias", "WSM"):
        return "params", path, leaf
    raise KeyError(f"no Flax name for {key}")


def flax_paths(module: nn.Module) -> Dict[str, str]:
    """The Flax path (`class_net/conv_0/dw/kernel`, under its collection) of
    each parameter and buffer of `module`, by state_dict key."""
    subs = dict(module.named_modules())
    out = {}
    for key, tensor in module.state_dict().items():
        _, path, name = _flax_name(subs, key, tensor.dim())
        out[key] = "/".join(path + [name])
    return out


def named_kernel_parameters(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(Flax path, parameter) of every parameter of `module` whose Flax name
    is `kernel` (every conv kernel, depthwise and transposed ones
    included), in module order."""
    paths = flax_paths(module)
    return [(paths[key], p) for key, p in module.named_parameters()
            if paths[key].endswith("/kernel")]


def kernel_parameters(module: nn.Module) -> List[torch.Tensor]:
    """The parameters of `module` whose Flax name is `kernel`, in module order."""
    return [p for _, p in named_kernel_parameters(module)]


def to_flax_tree(module: nn.Module, tensors: Mapping[str, torch.Tensor]
                 ) -> Dict[str, Dict]:
    """Tensors keyed by `module`'s parameter names (an EMA, a momentum
    buffer) as a Flax `params` tree of float32 numpy arrays, the layouts as
    `torch_to_flax`'s."""
    subs = dict(module.named_modules())
    out: Dict[str, Dict] = {}
    for key, tensor in tensors.items():
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        _, path, name = _flax_name(subs, key, arr.ndim)
        if name == "kernel":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        node = out
        for seg in path:
            node = node.setdefault(seg, {})
        node[name] = np.array(arr, order="C")
    return out


def from_flax_tree(module: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of `to_flax_tree`: a Flax `params` tree as CPU float32
    tensors keyed by `module`'s parameter names; raises on a missing leaf
    or a shape that differs from the parameter's."""
    subs = dict(module.named_modules())
    out = {}
    for key, p in module.named_parameters():
        _, path, name = _flax_name(subs, key, p.dim())
        node = tree
        for seg in path + [name]:
            if not isinstance(node, Mapping) or seg not in node:
                raise KeyError(f"{'/'.join(path + [name])} missing for {key}")
            node = node[seg]
        arr = np.array(node, dtype=np.float32)
        if name == "kernel":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key}: Flax shape {arr.shape} vs module shape "
                             f"{tuple(p.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def torch_to_flax(module: nn.Module) -> Dict[str, Dict]:
    """The inverse of `load_flax_variables`: `module`'s weights as Flax
    `{'params', 'batch_stats'}` variables, nested dicts of float32 numpy
    arrays (what `ckpt/io.save_pytree` writes and the JAX package reads)."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    subs = dict(module.named_modules())
    for key, tensor in module.state_dict().items():
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        collection, path, name = _flax_name(subs, key, arr.ndim)
        if name == "kernel":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        node = out[collection]
        for seg in path:
            node = node.setdefault(seg, {})
        node[name] = np.array(arr, order="C")  # a copy: never the live tensor
    return out
