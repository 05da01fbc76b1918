"""K19's host-side plan at the published AFNO recipes' shapes: the weight
pass's mode ranges (``grad_splits``, ``grad_ranges``) and the hidden
buffers' mode-contiguous storage (``hidden_like``), which the plain version's
o1 shares. No JAX and no card."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from makani_torch.ops import afno_mixer as am
from makani_torch.utils.yparams import YParams
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("config", ["afno_26ch", "afno_73ch", "afnov2_73ch"])
def test_weight_pass_ranges_cover_the_modes_once(config):
    """At each recipe's token grid (patch 8: 90 x 91 modes), embed 768 in 8
    blocks of 96, hidden factor 1, and batch 1 and the recipe's batch: S
    ranges, in order, that tile the B M modes once with none empty, and
    blocks for one wave of an H100's 132 streaming multiprocessors."""
    p = YParams(os.path.join(REPO, "config", "afnonet.yaml"), config)
    H, Wh = p.img_shape_x // p.patch_size[0], p.img_shape_y // p.patch_size[1] // 2 + 1
    nb = p.num_blocks
    bs = p.embed_dim // nb
    hbs = bs * p.get("hidden_size_factor", 1)
    assert (H, Wh, nb, bs, hbs) == (90, 91, 8, 96, 96)
    for B in (1, p.batch_size):
        S = am.grad_splits(B, H * Wh, nb, bs, hbs, 132)
        ranges = am.grad_ranges(B, H * Wh, S)
        assert S == 4 and len(ranges) == S
        assert ranges[0][0] == 0 and ranges[-1][1] == B * H * Wh
        assert all(lo < hi for lo, hi in ranges) and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert 2 * nb * 2 * S <= 132  # (dW1, dW2) x 2 tiles of 48 output channels x nb x S blocks


def test_grad_splits_edges():
    """Few modes give at most one range a 16 modes; wide blocks (more tiles
    than streaming multiprocessors) one range."""
    assert am.grad_splits(1, 35, 2, 20, 40, 132) == 3  # ceil(35 / 16)
    assert am.grad_splits(1, 7, 4, 8, 8, 132) == 1
    assert am.grad_splits(2, 8190, 64, 200, 400, 132) == 1
    ranges = am.grad_ranges(2, 35, 3)
    assert ranges == [(0, 23), (23, 46), (46, 70)]


def test_hidden_storage_is_mode_contiguous():
    """``hidden_like`` is a (B, nb, M, hbs, 2) view of a (B, nb, hbs, M, 2)
    storage, and the plain version's o1 comes back in the same strides and
    values as its einsums give."""
    B, H, Wh, nb, bs, hbs = 2, 5, 4, 3, 4, 8
    h = am.hidden_like(B, nb, H * Wh, hbs, "cpu")
    assert tuple(h.shape) == (B, nb, H * Wh, hbs, 2) and h.stride() == (nb * hbs * H * Wh * 2, hbs * H * Wh * 2, 2, H * Wh * 2, 1)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, H, Wh, nb * bs, 2)).astype(np.float32))
    w1 = torch.from_numpy(0.3 * rng.standard_normal((nb, 2, bs, hbs)).astype(np.float32))
    w2 = torch.from_numpy(0.3 * rng.standard_normal((nb, 2, hbs, bs)).astype(np.float32))
    _, href = am.afno_mixer_plain(x, w1, None, w2, None, 0.01, am.band_v2(H, Wh, 1.0), return_hidden=True)
    assert href.stride() == h.stride()
    xr = x[..., 0].reshape(B, H * Wh, nb, bs)
    xi = x[..., 1].reshape(B, H * Wh, nb, bs)
    o1r = torch.relu(torch.einsum("bmki,kio->bkmo", xr, w1[:, 0]) - torch.einsum("bmki,kio->bkmo", xi, w1[:, 1]))
    torch.testing.assert_close(href[..., 0], o1r, rtol=1e-5, atol=1e-5)
