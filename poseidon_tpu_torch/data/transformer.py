"""DataTransformer: crop / mirror / mean-subtract / scale, Caffe-exact (the
port's numpy copy of ``poseidon_tpu/data/transformer.py``).

Spec: ``src/caffe/data_transformer.cpp`` —
- random crop offsets in [0, dim - crop] at TRAIN, center crop at TEST;
- mirror flips the width axis at TRAIN;
- a full-size mean (``mean_file``) is indexed at the *source* (cropped)
  position; per-channel ``mean_value``s broadcast; then (x - mean) * scale.

The offsets and flips are drawn from a ``numpy.random.RandomState`` in the
JAX package's order, so both packages produce the same batches bit for bit
from the same seed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..proto.messages import TransformationParameter


class DataTransformer:
    def __init__(self, param: TransformationParameter, phase: str,
                 mean: Optional[np.ndarray] = None, seed: int = 0):
        self.param = param
        self.phase = phase
        self.rng = np.random.RandomState(seed)
        self.mean = None
        if param.mean_file:
            from ..proto.wire import read_blob_file
            self.mean = read_blob_file(param.mean_file)[0]  # (C, H, W)
        elif mean is not None:
            self.mean = np.asarray(mean, np.float32)
        self.mean_values = np.asarray(param.mean_value, np.float32) \
            if param.mean_value else None

    def output_shape(self, channels: int, height: int, width: int):
        c = self.param.crop_size
        if c:
            return (channels, c, c)
        return (channels, height, width)

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        """batch: (N, C, H, W) float32 raw datum values (never mutated)."""
        x = np.array(batch, np.float32)  # copy: the mirror path writes in place
        n, c, h, w = x.shape
        crop = self.param.crop_size
        train = self.phase == "TRAIN"

        if crop:
            if crop > h or crop > w:
                raise ValueError(f"crop_size {crop} exceeds image {h}x{w}")
            if train and (h > crop or w > crop):
                h_off = self.rng.randint(0, h - crop + 1, size=n)
                w_off = self.rng.randint(0, w - crop + 1, size=n)
            else:
                h_off = np.full(n, (h - crop) // 2)
                w_off = np.full(n, (w - crop) // 2)
            idx_h = h_off[:, None] + np.arange(crop)[None, :]
            idx_w = w_off[:, None] + np.arange(crop)[None, :]
            cropped = x[np.arange(n)[:, None, None, None],
                        np.arange(c)[None, :, None, None],
                        idx_h[:, None, :, None],
                        idx_w[:, None, None, :]]
            if self.mean is not None:
                # mean indexed at the source crop position (reference behavior)
                m = self.mean[np.arange(c)[None, :, None, None],
                              idx_h[:, None, :, None],
                              idx_w[:, None, None, :]]
                cropped = cropped - m
            elif self.mean_values is not None:
                cropped = cropped - self._mv(c)
            x = cropped
        else:
            if self.mean is not None:
                x = x - self.mean[None]
            elif self.mean_values is not None:
                x = x - self._mv(c)

        if self.param.mirror and train:
            flip = self.rng.randint(0, 2, size=n).astype(bool)
            x[flip] = x[flip, :, :, ::-1]

        if self.param.scale != 1.0:
            x = x * self.param.scale
        return np.ascontiguousarray(x, np.float32)

    def _mv(self, channels: int) -> np.ndarray:
        mv = self.mean_values
        if mv.size == 1:
            mv = np.repeat(mv, channels)
        if mv.size != channels:
            raise ValueError(
                f"mean_value: specify 1 or {channels} values, got {mv.size}")
        return mv.reshape(1, channels, 1, 1)
