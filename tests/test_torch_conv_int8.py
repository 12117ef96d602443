"""The int8 conv kernel's weight layout and K order (`ops/conv_int8.py`), on
the CPU, against JAX's int8 conv.

- `pack_int8_weights` puts w[co, c, i, j] at row co, column (i*kw + j)*Cp + c
  (Cp = C padded to C_STEP), with zero rows to a multiple of CO_STEP, zero
  columns past C in each tap and past the last tap to a multiple of K_STEP.
- `sums_packed_plain` (the dense kernel's implicit GEMM in its own K order)
  equals `sums_plain` and `lax.conv_general_dilated` on int8 operands with
  int32 sums, bit for bit, at shapes off the kernel's steps: C 3 and 13
  (not multiples of 4), C 40 at k3 (taps straddling the 64-wide K steps),
  Co off the 32-row and tile steps, a 1x1 map, stride
  2 at odd sizes, explicit asymmetric pads, VALID, and a k5 depthwise conv
  through its block-diagonal dense equivalent.
- `Int8Serve`'s convs pack their weights once, when built: a call passes
  the same packed tensor and packs nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mladversarialobjectdetection_torch.inference import quantize as pquant
from mladversarialobjectdetection_torch.models import efficientnet
from mladversarialobjectdetection_torch.ops import conv_int8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread (the tier-1 run shares the CPU among six
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lax_sums(xq, wq, stride, padding, groups):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq.transpose(0, 2, 3, 1)), jnp.asarray(wq.transpose(2, 3, 1, 0)),
        window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32)).transpose(0, 3, 1, 2)


def _dense_equivalent(wq: np.ndarray) -> np.ndarray:
    """Depthwise [C, 1, kh, kw] as dense block-diagonal [C, C, kh, kw]."""
    c = wq.shape[0]
    dense = np.zeros((c, c) + wq.shape[2:], np.int8)
    dense[np.arange(c), np.arange(c)] = wq[:, 0]
    return dense


def test_pack_int8_weights_layout():
    rng = np.random.default_rng(0)
    wq = rng.integers(-127, 128, (37, 13, 3, 2)).astype(np.int8)
    packed = conv_int8.pack_int8_weights(torch.from_numpy(wq)).numpy()
    assert conv_int8.C_STEP == 4 and conv_int8.K_STEP == 64 and conv_int8.CO_STEP == 32
    assert packed.dtype == np.int8
    assert packed.shape == (64, 128)  # 6 taps x 16 channels = 96, padded to 128
    want = np.zeros((64, 128), np.int8)
    for i in range(3):
        for j in range(2):
            want[:37, (i * 2 + j) * 16:(i * 2 + j) * 16 + 13] = wq[:, :, i, j]
    np.testing.assert_array_equal(packed, want)


# (name, B, C, H, W, Co, k, stride, padding, depthwise)
CASES = [
    ("stem C 3 k3 s2", 2, 3, 15, 17, 32, 3, 2, "SAME", False),
    ("C 40 k3 over K steps", 1, 40, 7, 6, 33, 3, 1, "SAME", False),
    ("C 13 k3", 2, 13, 9, 11, 20, 3, 1, "SAME", False),
    ("Co 40 off the rows", 1, 24, 6, 7, 40, 1, 1, "SAME", False),
    ("Co 130 off the tiles, C 70", 1, 70, 5, 5, 130, 1, 1, "SAME", False),
    ("1x1 map", 3, 16, 1, 1, 9, 1, 1, "SAME", False),
    ("1x1 map k3", 2, 5, 1, 1, 7, 3, 1, "SAME", False),
    ("stride 2 at odd 13x9", 1, 6, 13, 9, 11, 3, 2, "SAME", False),
    ("asymmetric pads", 2, 8, 11, 9, 12, 3, 1, ((2, 0), (0, 1)), False),
    ("halo rows s2", 1, 6, 13, 10, 4, 3, 2, ((0, 0), (0, 1)), False),
    ("VALID k5", 1, 5, 11, 10, 6, 5, 1, "VALID", False),
    ("k5 depthwise s2 odd", 2, 10, 15, 13, 10, 5, 2, "SAME", True),
    ("k5 depthwise uneven pads", 1, 7, 11, 9, 7, 5, 1, ((2, 1), (0, 2)), True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sums_packed_plain_equal_plain_and_lax(case):
    _, b, c, h, w, co, k, s, pad, dw = case
    rng = np.random.default_rng(sum(case[1:8]))
    xq = rng.integers(-127, 128, (b, c, h, w)).astype(np.int8)
    wq = rng.integers(-127, 128, (co, 1 if dw else c, k, k)).astype(np.int8)
    groups = c if dw else 1
    want = _lax_sums(xq, wq, s, pad, groups)
    xt = torch.from_numpy(xq)
    plain = conv_int8.sums_plain(xt, torch.from_numpy(wq), stride=s, padding=pad,
                                 groups=groups)
    np.testing.assert_array_equal(plain.numpy(), want)
    dense = torch.from_numpy(_dense_equivalent(wq) if dw else wq)
    got = conv_int8.sums_packed_plain(xt, conv_int8.pack_int8_weights(dense), dense.shape,
                                      stride=s, padding=pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sums_packed_plain_refuses_other_weights():
    wq = torch.zeros((8, 5, 3, 3), dtype=torch.int8)
    xq = torch.zeros((1, 5, 6, 6), dtype=torch.int8)
    with pytest.raises(ValueError, match="packed"):
        conv_int8.sums_packed_plain(xq, conv_int8.pack_int8_weights(wq[:, :, :1, :1]),
                                    wq.shape)
    with pytest.raises(TypeError):
        conv_int8.sums_packed_plain(xq.float(), conv_int8.pack_int8_weights(wq), wq.shape)


def test_conv_int8_cuda_names_its_instances():
    x = torch.zeros((1, 4, 3, 3))
    wq = torch.zeros((4, 4, 1, 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="instance"):
        conv_int8.conv_int8_cuda(x, 0.1, wq, torch.ones(4), instance="wgmma")
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv_int8.conv_int8_cuda(x, 0.1, wq, torch.ones(4), instance="simt")
    conv_int8.INSTANCE_LAUNCHES["sm90"] += 1
    conv_int8.reset_counts()
    assert conv_int8.INSTANCE_LAUNCHES == {"sm90": 0, "simt": 0}
    assert conv_int8.LAUNCHES == conv_int8.CALLS == 0


@pytest.mark.parametrize("groups", [1, 6])
def test_qconv_packs_its_weights_once(monkeypatch, groups):
    """A quantised conv packs a dense conv's weights when it is built, and
    each call hands the conv that same tensor; a depthwise conv packs none."""
    torch.manual_seed(0)
    mod = efficientnet.Conv2d(6, 6, 3, stride=1, groups=groups, init="fan_out_normal")
    k = mod.weight.detach().numpy()
    w_scale = (np.maximum(np.abs(k).max(axis=(1, 2, 3)), 1e-8) / 127.0).astype(np.float32)
    wq = torch.from_numpy(np.clip(np.round(k / w_scale[:, None, None, None]), -127, 127)
                          .astype(np.int8))
    packs, seen = [], []
    pack = conv_int8.pack_int8_weights
    monkeypatch.setattr(conv_int8, "pack_int8_weights",
                        lambda w: packs.append(1) or pack(w))
    q = pquant._QConv(mod, 0.05, wq, torch.from_numpy(w_scale), mod.bias.detach(), "cpu")
    assert len(packs) == (groups == 1)
    plain = conv_int8.conv_int8

    def conv(*args, packed=None, **kw):
        seen.append(packed)
        return plain(*args, **kw)

    monkeypatch.setattr(conv_int8, "conv_int8", conv)
    x = torch.randn(2, 6, 7, 9)
    outs = [q.forward(x) for _ in range(3)]
    assert len(packs) == (groups == 1)
    if groups == 1:
        assert all(p is q.packed for p in seen)
        np.testing.assert_array_equal(q.packed.numpy(), pack(q.wq).numpy())
    else:
        assert q.packed is None and seen == [None] * 3
    want = conv_int8.conv_int8_plain(x, 0.05, q.wq, q.scale, q.bias, padding="SAME",
                                     groups=groups)
    for y in outs:
        assert torch.equal(y, want)
