"""WINDOW_DATA: R-CNN-style detection-window sampling (the port of
``poseidon_tpu/data/window.py``, Caffe's ``window_data_layer.cpp``).

The window file lists images with candidate boxes ('# idx / path / C H W /
num / class overlap x1 y1 x2 y2'); boxes with overlap >= fg_threshold are
foreground, those below bg_threshold background (label forced to 0). A
batch samples ``fg_fraction`` foreground windows, crops each box plus
``context_pad`` and warps it to crop_size x crop_size by nearest neighbour
("warp"; "square" takes the tightest square first). The random stream is
numpy's ``RandomState``, as in the JAX package, so a seed gives the same
batches bit for bit in both.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..proto.messages import LayerParameter


@dataclass
class Window:
    image_index: int
    label: int
    overlap: float
    x1: int
    y1: int
    x2: int
    y2: int


def parse_window_file(path: str, fg_threshold: float, bg_threshold: float):
    """-> (images [(path, (C, H, W))], foreground windows, background
    windows); a window between the thresholds is dropped."""
    images: List[Tuple[str, Tuple[int, int, int]]] = []
    fg: List[Window] = []
    bg: List[Window] = []
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    while i < len(tokens):
        if tokens[i] != "#":
            raise ValueError(f"{path}: expected '#', got {tokens[i]!r}")
        img_index = int(tokens[i + 1])
        img_path = tokens[i + 2]
        c, h, w = (int(tokens[i + 3]), int(tokens[i + 4]), int(tokens[i + 5]))
        num_windows = int(tokens[i + 6])
        i += 7
        if img_index != len(images):
            raise ValueError(f"{path}: non-sequential image index {img_index}")
        images.append((img_path, (c, h, w)))
        for _ in range(num_windows):
            label, overlap = int(tokens[i]), float(tokens[i + 1])
            x1, y1, x2, y2 = (int(tokens[i + 2]), int(tokens[i + 3]),
                              int(tokens[i + 4]), int(tokens[i + 5]))
            i += 6
            win = Window(img_index, label, overlap, x1, y1, x2, y2)
            if overlap >= fg_threshold:
                if label <= 0:
                    raise ValueError(f"{path}: foreground window with "
                                     f"label {label}")
                fg.append(win)
            elif overlap < bg_threshold:
                win.label = 0
                win.overlap = 0.0
                bg.append(win)
    return images, fg, bg


class WindowDataSource:
    """The batch sampler of a WINDOW_DATA layer. Not index-addressable as
    the other sources are: a batch is a stochastic fg/bg mix, as in the
    reference. Decoded images stay in an LRU cache of
    ``MAX_CACHED_IMAGES``."""

    MAX_CACHED_IMAGES = 64

    def __init__(self, lp: LayerParameter, phase: str, seed: int = 0):
        from .pipeline import _effective_transform
        wp = lp.window_data_param
        self.param = wp
        self.phase = phase
        tp = _effective_transform(lp)
        self.crop_size = tp.crop_size
        if not self.crop_size:
            raise ValueError(f"layer {lp.name!r}: WINDOW_DATA needs crop_size")
        self.mirror = tp.mirror
        self.scale = tp.scale
        self.mean_values = (np.asarray(tp.mean_value, np.float32)
                            if tp.mean_value else None)
        self.mean_patch = None
        if tp.mean_file:
            from ..proto.wire import read_blob_file
            mean = read_blob_file(tp.mean_file)[0]  # (C, H, W)
            # the reference indexes the mean at its center crop
            oh = (mean.shape[1] - self.crop_size) // 2
            ow = (mean.shape[2] - self.crop_size) // 2
            if oh < 0 or ow < 0:
                raise ValueError("mean_file smaller than crop_size")
            self.mean_patch = mean[:, oh:oh + self.crop_size,
                                   ow:ow + self.crop_size]
        self.images, self.fg, self.bg = parse_window_file(
            wp.source, wp.fg_threshold, wp.bg_threshold)
        if not self.fg or not self.bg:
            raise ValueError(f"{wp.source}: need both fg and bg windows")
        self.rng = np.random.RandomState(seed)
        self._img_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        first = self._load_image(0)
        self.record_shape = (first.shape[0], self.crop_size, self.crop_size)

    def _load_image(self, index: int) -> np.ndarray:
        if index in self._img_cache:
            self._img_cache.move_to_end(index)
            return self._img_cache[index]
        from PIL import Image
        path, (c, h, w) = self.images[index]
        img = Image.open(path).convert("RGB" if c == 3 else "L")
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        elif c == 3:
            arr = arr[:, :, ::-1]  # BGR
        chw = np.ascontiguousarray(arr.transpose(2, 0, 1))
        self._img_cache[index] = chw
        if len(self._img_cache) > self.MAX_CACHED_IMAGES:
            self._img_cache.popitem(last=False)
        return chw

    def _crop_warp(self, win: Window) -> np.ndarray:
        img = self._load_image(win.image_index)
        c, h, w = img.shape
        pad = self.param.context_pad
        x1, y1, x2, y2 = win.x1 - pad, win.y1 - pad, win.x2 + pad, win.y2 + pad
        if self.param.crop_mode == "square":
            cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
            half = max(x2 - x1, y2 - y1) / 2.0
            x1, x2 = int(cx - half), int(cx + half)
            y1, y2 = int(cy - half), int(cy + half)
        x1c, y1c = max(x1, 0), max(y1, 0)
        x2c, y2c = min(x2, w - 1), min(y2, h - 1)
        patch = img[:, y1c:y2c + 1, x1c:x2c + 1]
        # a nearest-neighbour warp (the reference uses cv::resize)
        cs = self.crop_size
        hh, ww = patch.shape[1], patch.shape[2]
        if hh == 0 or ww == 0:
            return np.zeros((c, cs, cs), np.float32)
        yi = np.clip((np.arange(cs) * hh / cs).astype(int), 0, hh - 1)
        xi = np.clip((np.arange(cs) * ww / cs).astype(int), 0, ww - 1)
        return patch[:, yi[:, None], xi[None, :]].astype(np.float32)

    def batch(self, batch_size: int):
        """-> (data (B, C, crop, crop) f32, labels (B,) int32): the first
        round(B * fg_fraction) rows foreground, the rest background."""
        n_fg = int(round(batch_size * self.param.fg_fraction))
        data = np.empty((batch_size,) + self.record_shape, np.float32)
        labels = np.empty((batch_size,), np.int32)
        for i in range(batch_size):
            pool = self.fg if i < n_fg else self.bg
            win = pool[self.rng.randint(len(pool))]
            patch = self._crop_warp(win)
            if self.mean_patch is not None:
                patch = patch - self.mean_patch
            elif self.mean_values is not None:
                patch = patch - self.mean_values.reshape(-1, 1, 1)
            if self.scale != 1.0:
                patch = patch * self.scale
            if self.mirror and self.phase == "TRAIN" and self.rng.randint(2):
                patch = patch[:, :, ::-1]
            data[i] = patch
            labels[i] = win.label
        return data, labels
