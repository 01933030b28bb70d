"""MGDataset, the EXR material-GT loader on the host (counterpart of
``materialist_tpu/models/dataset.py``).

Scenes are listed in ``<root>/{train,val,test}.txt``; a sample is
``<scene>/<i>_im.exr`` with ``_albedo``, ``_material`` (roughness,
metallic, specular), ``_depth``, ``_normal`` and an optional ``_mask``
sibling. Maps are resized to (height, width): bilinear with aligned
corners for the image and albedo, nearest for the rest; depth is scaled
by 1e-3 (mm to scene units), NaN and inf become 0, normals are
renormalized, and a random horizontal flip (``np.random``) negates
normal-x. Samples are NHWC numpy arrays, as the JAX package gives them;
the trainer moves them to its device.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional

import numpy as np

from materialist_tpu_torch.io import exr as exr_io
from materialist_tpu_torch.io import image as image_io

SCENE_SCALE = 1e-3


class MGDataset:
    def __init__(self, data_root: str, im_height: int = 240,
                 im_width: int = 320, phase: str = "TRAIN",
                 scene_list: Optional[List[str]] = None,
                 random_flip: bool = False):
        if scene_list is None:
            scene_file = os.path.join(data_root, f"{phase.lower()}.txt")
            with open(scene_file) as f:
                scene_list = [x.strip() for x in f if x.strip()]
        self.im_list = []
        for s in scene_list:
            self.im_list += sorted(glob.glob(
                os.path.join(data_root, s, "*_im.exr")))
        self.h, self.w = im_height, im_width
        self.random_flip = random_flip
        print(f"{len(self.im_list)} images for {phase}")

    def __len__(self):
        return len(self.im_list)

    def _load(self, path, nearest=False):
        img = exr_io.read(path)
        if img.shape[:2] != (self.h, self.w):
            if nearest:
                ys = np.arange(self.h) * img.shape[0] // self.h
                xs = np.arange(self.w) * img.shape[1] // self.w
                img = img[ys][:, xs]
            else:
                img = image_io.resize_bilinear_align_corners(
                    img, (self.h, self.w))
        return np.nan_to_num(img, nan=0.0, posinf=0.0, neginf=0.0)

    def __getitem__(self, index: int) -> dict:
        im_path = self.im_list[index]
        im = self._load(im_path)
        albedo = self._load(im_path.replace("_im", "_albedo"))
        mat = self._load(im_path.replace("_im", "_material"), nearest=True)
        depth = self._load(im_path.replace("_im", "_depth"),
                           nearest=True)[..., :1] * SCENE_SCALE
        normal = self._load(im_path.replace("_im", "_normal"), nearest=True)
        normal = normal / np.maximum(
            np.linalg.norm(normal, axis=-1, keepdims=True), 1e-6)
        mask_path = im_path.replace("_im", "_mask")
        if os.path.exists(mask_path):
            seg = self._load(mask_path, nearest=True)[..., :1] > 0.5
        else:
            seg = np.ones_like(depth, bool)

        sample = {
            "im": im, "albedo": albedo,
            "roughness": mat[..., 0:1], "metallic": mat[..., 1:2],
            "specular": mat[..., 2:3],
            "depth": depth, "normal": normal, "mask": seg,
        }
        if self.random_flip and np.random.rand() < 0.5:
            for k in sample:
                sample[k] = np.ascontiguousarray(sample[k][:, ::-1])
            sample["normal"][..., 0] *= -1.0
        return sample

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0) -> Iterator[dict]:
        """Stacked (B, H, W, C) batches; the order is shuffled by
        ``np.random.default_rng(seed)``, a partial last batch dropped."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[j] for j in order[i:i + batch_size]]
            yield {k: np.stack([it[k] for it in items])
                   for k in items[0]}
