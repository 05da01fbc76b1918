"""FCN3's processor channel mix (kernel K8's wrapper and plain version) and
the responses layout it reads, on the CPU.

``DiscoConv._mix`` is held to the JAX package's two-stage mix, the jitted
einsum ``"bgikhw,goik->bhwgo"`` of ``makani_tpu/models/networks/
fourcastnet3.py`` (``DiscoConv.__call__``), on seeded numpy responses whose
depth C*K is not a multiple of 8, read through a pixel stride padded to a
multiple of four floats as K5 writes them: fp32 max|diff| <= 1e-5 * max|ref|.
The host side of K8 (the weight's TF32 planes and their cache) and of K5's
padded output (``pixel_stride``) is checked without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from makani_torch import kernels
from makani_torch.models.networks.fourcastnet3 import DiscoConv
from makani_torch.ops import disco, disco_kernels
from makani_torch.ops.sht import tf32_split
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _conv(C, Cout):
    op = disco.DiscoConvS2((16, 32), (16, 32), (3, 3), basis_type="morlet th", basis_norm_mode="mean")
    return DiscoConv(op, C, Cout, device="cpu")


@pytest.mark.parametrize("C,Cout", [(7, 5), (13, 20)])
def test_mix_matches_jax_einsum(C, Cout):
    conv = _conv(C, Cout)
    K = conv.conv_op.K
    assert (C * K) % 8 != 0
    B, H, W = 2, 6, 10
    rng = np.random.default_rng(3)
    t = rng.standard_normal((B, C, K, H, W)).astype(np.float32)
    w = (0.1 * rng.standard_normal((1, Cout, C, K))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a, b: jnp.einsum("bgikhw,goik->bhwgo", a, b))(t.reshape(B, 1, C, K, H, W), w)).reshape(B, H, W, Cout)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
    # the responses as responses_cl allocates them: pixels a multiple of 4 floats apart
    CKp = -(-C * K // disco.RESPONSE_ALIGN) * disco.RESPONSE_ALIGN
    buf = torch.full((B, H, W, CKp), float("nan"))
    tt = buf[..., : C * K].view(B, H, W, C, K)
    tt.copy_(torch.from_numpy(t).permute(0, 3, 4, 1, 2))
    kernels.reset_launch_counts()
    with torch.no_grad():
        for use in (True, False):
            conv.use_kernels = use
            y = conv._mix(tt).numpy()
            assert y.shape == ref.shape and np.max(np.abs(y - ref)) <= 1e-5 * np.max(np.abs(ref))
    assert kernels.LAUNCHES["disco_mix"] == 0


def test_responses_rows_are_16_byte_pieces():
    """responses_cl lays t out with pixels a multiple of 4 floats apart, and
    t seen as K8's (R, C*K) operand is a view of it, not a copy."""
    op = disco.DiscoConvS2((16, 32), (16, 32), (3, 3), basis_type="morlet th", basis_norm_mode="mean")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 32, 5)).astype(np.float32))
    t, _ = op.responses_cl(x)
    CK = 5 * op.K
    assert t.stride(2) % 4 == 0 and t.stride(2) >= CK and t.stride()[3:] == (op.K, 1)
    t2 = t.reshape(-1, CK)
    assert t2.data_ptr() == t.data_ptr() and t2.stride() == (t.stride(2), 1)
    assert disco_kernels.pixel_stride(t.view(*t.shape[:3], CK)) == t.stride(2)
    with pytest.raises(ValueError):
        disco_kernels.pixel_stride(torch.empty(2, 3, 4, 6).transpose(1, 2))


def test_mix_planes_and_cache():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((13, 45)).astype(np.float32))
    planes = disco_kernels.mix_planes(w)
    # padded to K8's 136-column tile and 32-deep stage, zeros outside w
    assert planes.shape == (2, 136, 64) and planes.dtype == torch.float32
    assert not planes[:, 13:].any() and not planes[:, :, 45:].any()
    hi, lo = tf32_split(w)
    assert torch.equal(planes[0, :13, :45], hi) and torch.equal(planes[1, :13, :45], lo)
    # hi has TF32's 10 mantissa bits, and hi + lo holds w to ~2**-22
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert (hi + lo - w).abs().max() <= 2.0**-21 * w.abs().max()
    cache = disco_kernels.MixPlanes()
    p1 = cache.get(w)
    assert cache.get(w) is p1
    with torch.no_grad():
        w.mul_(2.0)
    p2 = cache.get(w)
    assert p2 is not p1 and torch.equal(p2, 2.0 * p1)


def test_mix_wrapper_takes_plain_on_cpu_without_counting():
    rng = np.random.default_rng(2)
    t2 = torch.from_numpy(rng.standard_normal((9, 48)).astype(np.float32))[:, :45]
    w = torch.from_numpy(rng.standard_normal((7, 45)).astype(np.float32))
    kernels.reset_launch_counts()
    assert torch.equal(disco_kernels.channel_mix(t2, w), disco_kernels.channel_mix_plain(t2, w))
    assert kernels.LAUNCHES["disco_mix"] == 0
