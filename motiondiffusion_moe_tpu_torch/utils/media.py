"""Image / GIF composition helpers.

A copy of ``motiondiffusion_moe_tpu/utils/media.py`` (numpy and PIL only,
no device), kept in the port so that it imports nothing of the JAX
package. Capability match of ``text2motion/utils/utils.py:61-123``:
frame-list -> GIF, image grids, and list smoothing.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence

import numpy as np


def compose_gif_img_list(img_list: Sequence[np.ndarray], fp_out: str,
                         duration: float) -> None:
    """Save a list of HxWx3 frames as an animated GIF
    (``utils/utils.py:61-65``)."""
    from PIL import Image

    img, *imgs = [Image.fromarray(np.asarray(im).astype(np.uint8))
                  for im in img_list]
    img.save(fp=fp_out, format="GIF", append_images=imgs, optimize=False,
             save_all=True, loop=0, duration=duration)


def save_images(visuals: Dict[str, np.ndarray], image_path: str) -> None:
    """Save a dict of label -> image arrays as numbered jpgs
    (``utils/utils.py:68-75``)."""
    from PIL import Image

    os.makedirs(image_path, exist_ok=True)
    for i, (label, img) in enumerate(visuals.items()):
        Image.fromarray(np.asarray(img).astype(np.uint8)).save(
            os.path.join(image_path, f"{i}_{label}.jpg"))


def compose_image(img_list: Sequence[np.ndarray], col: int, row: int,
                  img_size) -> "object":
    """Tile images into a col x row grid (``utils/utils.py:96-108``)."""
    from PIL import Image

    to_image = Image.new("RGB", (col * img_size[0], row * img_size[1]))
    for y in range(row):
        for x in range(col):
            from_img = Image.fromarray(
                np.asarray(img_list[y * col + x]).astype(np.uint8))
            to_image.paste(from_img, (x * img_size[0], y * img_size[1],
                                      (x + 1) * img_size[0],
                                      (y + 1) * img_size[1]))
    return to_image


def compose_and_save_img(img_list: Sequence[np.ndarray], save_dir: str,
                         img_name: str, col: int = 4, row: int = 1,
                         img_size=(256, 200)) -> None:
    """(``utils/utils.py:85-93``)."""
    img = compose_image(img_list, col, row, img_size)
    os.makedirs(save_dir, exist_ok=True)
    img.save(os.path.join(save_dir, img_name))


def list_cut_average(ll: Sequence[float], intervals: int) -> List[float]:
    """Bucket-average a list (``utils/utils.py:111-122``)."""
    if intervals == 1:
        return list(ll)
    bins = math.ceil(len(ll) / intervals)
    return [float(np.mean(ll[i * intervals: min((i + 1) * intervals, len(ll))]))
            for i in range(bins)]
