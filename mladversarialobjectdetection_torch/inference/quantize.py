"""Opt-in int8 post-training-quantized serving (W8A8 with float glue).

Port of `mladversarialobjectdetection_tpu/inference/quantize.py`, in
PyTorch's idiom:

- every eligible conv of the serve program is an `efficientnet.Conv2d`
  (`conv_eligible`, JAX's `_conv_eligible`, quantize.py:59-72: a plain conv
  with string padding and no dilation, whose path matches no skip pattern;
  the segmentation head's `ConvTranspose` is not one);
- weights are quantised per output channel (symmetric int8), in numpy
  float32 as JAX does (quantize.py:110-127), over axes (1, 2, 3) of the
  port's OIHW kernels (JAX's HWIO axes (0, 1, 2)), so the int8 kernels are
  bit-equal to JAX's;
- activations are quantised per tensor with scales calibrated on
  representative frames: the abs-max of each conv's input over every call
  and every batch (`collect_act_scales`, forward pre-hooks keyed per module,
  so the heads' shared convs, called at 5 levels, max-combine);
- the conv runs int8 x int8 -> int32 (`ops/conv_int8.conv_int8`: the CUDA
  kernel on the card, the plain version on the CPU) and dequantises to the
  conv's output dtype (its compute dtype, or x's), plus its bias; BatchNorm,
  activations, residuals and postprocessing stay float;
- the heads' `predict` convs are skipped by default (`DEFAULT_SKIP`).

Every dict is keyed by the Flax path of the conv (`class_net/conv_0/pw`,
`ckpt/bridge.flax_paths`), so `act_scales` and `qkernels` compare with
JAX's key for key. The fused MBConv op never calls a block's expand,
depthwise and project convs, so calibration and the int8 forward run every
block unfused (`efficientnet.unfused_blocks`), as the JAX `Detector` does.

Differences from JAX's signatures: the module holds its weights, so
`collect_act_scales` and `Int8Serve` take the net (not an apply function
and a variables tree), and `Int8Serve(net, batches)` is called on images
alone; the int8 forward swaps each quantised conv's `forward` inside
`Int8Serve.active()` instead of intercepting Flax methods.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ckpt import bridge
from ..models import efficientnet
from ..ops import conv_int8 as conv_int8_ops
from ..utils.log import get_logger

logger = get_logger(__name__)

DEFAULT_SKIP = ("predict",)


def conv_modules(net: nn.Module) -> Dict[str, nn.Module]:
    """{Flax path: module} of every conv of `net` with a `kernel`."""
    subs = dict(net.named_modules())
    return {path[:-len("/kernel")]: subs[key.rpartition(".")[0]]
            for key, path in bridge.flax_paths(net).items() if path.endswith("/kernel")}


def conv_eligible(path: str, mod: nn.Module, skip_patterns: Sequence[str]) -> bool:
    """A plain `efficientnet.Conv2d` (Flax "SAME" padding, a string), no
    dilation, whose path matches no skip pattern (quantize.py:59-72)."""
    if type(mod) is not efficientnet.Conv2d:
        return False
    if any(p in path for p in skip_patterns):
        return False
    return tuple(mod.dilation) == (1, 1)


def eligible_convs(net: nn.Module, skip_patterns: Sequence[str] = DEFAULT_SKIP
                   ) -> Dict[str, nn.Module]:
    return {p: m for p, m in conv_modules(net).items()
            if conv_eligible(p, m, skip_patterns)}


def collect_act_scales(net: nn.Module, batches: Iterable[np.ndarray],
                       skip_patterns: Sequence[str] = DEFAULT_SKIP,
                       device=None) -> Dict[str, float]:
    """Run `net(images)` (eval mode, every block unfused) over calibration
    batches [B, H, W, 3], recording the abs-max input activation of every
    eligible conv, max-combined over its calls and the batches. Returns
    {path: abs-max} (host floats)."""
    convs = eligible_convs(net, skip_patterns)
    device = device or next(net.parameters()).device
    store: Dict[str, torch.Tensor] = {}

    def hook(path):
        def record(_mod, args):
            amax = args[0].to(torch.float32).abs().amax()
            store[path] = torch.maximum(store[path], amax) if path in store else amax
        return record

    handles = [m.register_forward_pre_hook(hook(p)) for p, m in convs.items()]
    scales: Dict[str, float] = {}
    try:
        with torch.no_grad(), efficientnet.unfused_blocks():
            for batch in batches:
                store.clear()
                net(torch.as_tensor(np.asarray(batch, np.float32), device=device))
                for p, v in store.items():
                    scales[p] = max(scales.get(p, 0.0), float(v))
    finally:
        for h in handles:
            h.remove()
    if not scales:
        raise ValueError("calibration saw no eligible convs")
    return scales


def _kernels(variables, paths: Iterable[str]) -> Dict[str, np.ndarray]:
    """{path: OIHW float32 kernel} from the net or from Flax variables."""
    if isinstance(variables, nn.Module):
        mods = conv_modules(variables)
        return {p: mods[p].weight.detach().to("cpu", torch.float32).numpy() for p in paths}
    out = {}
    for path in paths:
        node = variables["params"]
        for part in path.split("/"):
            node = node[part]
        out[path] = np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1)
    return out


def quantize_conv_params(variables, paths: Iterable[str]
                         ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Per-output-channel symmetric int8 quantisation of conv kernels.

    `variables`: the port's net (an `nn.Module`) or Flax variables. Returns
    {path: (int8 kernel [Co, C/g, kh, kw], float32 scale [Co])} (CPU
    tensors) where kernel ~= int8 * scale, in numpy float32 as JAX's."""
    out = {}
    for path, k in _kernels(variables, list(paths)).items():
        wmax = np.maximum(np.abs(k).max(axis=(1, 2, 3)), 1e-8)  # [Co]
        w_scale = (wmax / 127.0).astype(np.float32)
        k_q = np.clip(np.round(k / w_scale[:, None, None, None]), -127, 127).astype(np.int8)
        out[path] = (torch.from_numpy(k_q), torch.from_numpy(w_scale))
    return out


def extract_biases(variables, paths: Iterable[str]) -> Dict[str, Optional[torch.Tensor]]:
    """Conv biases (float32 CPU tensors) of the quantised paths; None where
    bias-free. `variables`: the port's net or Flax variables."""
    out = {}
    if isinstance(variables, nn.Module):
        mods = conv_modules(variables)
        for path in paths:
            b = mods[path].bias
            out[path] = None if b is None else b.detach().to("cpu", torch.float32).clone()
        return out
    for path in paths:
        node = variables["params"]
        for part in path.split("/"):
            node = node[part]
        b = node.get("bias") if isinstance(node, Mapping) else None
        out[path] = None if b is None else torch.from_numpy(np.array(b, np.float32))
    return out


class _QConv:
    """One quantised conv on the device: its int8 forward."""

    def __init__(self, mod: nn.Module, a_s: float, wq: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], device):
        self.mod = mod
        self.a_s = a_s
        self.wq = wq.to(device).contiguous()
        self.scale = torch.from_numpy(
            conv_int8_ops.dequant_scale(a_s, w_scale.numpy())).to(device)
        self.bias = None if bias is None else bias.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.mod
        return conv_int8_ops.conv_int8(
            x.contiguous(), self.a_s, self.wq, self.scale, self.bias, stride=m.stride,
            padding="SAME", groups=m.groups, out_dtype=m.compute_dtype or x.dtype)


class Int8Serve:
    """Quantized drop-in for the detector's forward.

    Built once from calibration batches ([B, H, W, 3] float32, preprocessed
    as serve inputs), then `int8(images)` runs the net with every quantised
    conv on `conv_int8` and every block unfused. `act_scales`, `qkernels`
    ({path: (int8 OIHW kernel, float32 w_scale)}, CPU) and `biases` are
    JAX's `Int8Serve` attributes and `state` entries, key for key.
    `Detector.quantize_int8` builds one."""

    def __init__(self, net: nn.Module, calibration_batches,
                 skip_patterns: Sequence[str] = DEFAULT_SKIP):
        self.net = net
        self.skip_patterns = tuple(skip_patterns)
        device = next(net.parameters()).device
        self.act_scales = collect_act_scales(net, calibration_batches, self.skip_patterns,
                                             device)
        self.qkernels = quantize_conv_params(net, self.act_scales)
        self.biases = extract_biases(net, self.qkernels)
        mods = conv_modules(net)
        self.convs = {
            p: _QConv(mods[p], conv_int8_ops.activation_scale(self.act_scales[p]), k_q,
                      w_scale, self.biases[p], device)
            for p, (k_q, w_scale) in self.qkernels.items()}
        n_params = sum(k.numel() for k, _ in self.qkernels.values())
        logger.info("int8 serve: %d convs quantized (%.1f MB int8 weights)",
                    len(self.qkernels), n_params / 1e6)

    @contextlib.contextmanager
    def active(self):
        """Inside: the net's quantised convs run `conv_int8`, every block
        unfused."""
        with efficientnet.unfused_blocks():
            for q in self.convs.values():
                q.mod.forward = q.forward
            try:
                yield
            finally:
                for q in self.convs.values():
                    del q.mod.forward

    def __call__(self, images: torch.Tensor):
        with self.active():
            return self.net(images)
