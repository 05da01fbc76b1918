"""Synthetic on-the-fly dataset (counterpart of
``makani_tpu/utils/dataloaders/data_loader_dummy.py``): the multifiles
dataset's sample interface over seeded random fields, for
``--enable_synthetic_data``."""

from __future__ import annotations

import numpy as np

__all__ = ["DummyDataset"]


class DummyDataset:
    def __init__(self, params, location: str = "", train: bool = True, n_samples: int = 64, final_eval: bool = False):
        self.params = params
        self.n_history = params.get("n_history", 0)
        self.n_future = params.get("n_future", 0) if train else params.get("valid_autoreg_steps", 0)
        self.add_zenith = params.get("add_zenith", False)
        self.img_shape = (params.get("img_shape_x"), params.get("img_shape_y"))
        self.n_in = len(params.get("in_channels", range(params.get("n_channels", 2))))
        self.n_out = len(params.get("out_channels", range(self.n_in)))
        self.n_samples = params.get("n_train_samples_per_epoch", n_samples) if train else params.get("n_eval_samples", n_samples)
        self.seed = params.get("seed", 333) + (0 if train else 1)

        self.in_bias = np.zeros((1, self.n_in, 1, 1), np.float32)
        self.in_scale = np.ones((1, self.n_in, 1, 1), np.float32)

    def __len__(self):
        return self.n_samples

    def get_normalization(self):
        return self.in_bias, self.in_scale

    def __getitem__(self, idx: int):
        rng = np.random.RandomState((self.seed + idx) % (2**31))
        H, W = self.img_shape
        # the full field from the seed, then the io tile: the values are a
        # function of the global coordinates
        tx = tuple(self.params.get("io_tile_x", (0, H)) or (0, H))
        ty = tuple(self.params.get("io_tile_y", (0, W)) or (0, W))
        sx, sy = slice(*tx), slice(*ty)
        inp = rng.randn(self.n_history + 1, self.n_in, H, W).astype(np.float32)[..., sx, sy]
        tar = rng.randn(self.n_future + 1, self.n_out, H, W).astype(np.float32)[..., sx, sy]
        sample = {"inp": inp, "tar": tar}
        if self.add_zenith:
            sample["izen"] = (rng.rand(self.n_history + 1, 1, H, W).astype(np.float32) * 2 - 1)[..., sx, sy]
            sample["tzen"] = (rng.rand(self.n_future + 1, 1, H, W).astype(np.float32) * 2 - 1)[..., sx, sy]
        return sample
