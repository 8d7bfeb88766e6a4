"""Image directory I/O through Pillow (port of particlesfm_tpu/io/images.py)."""
from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np
from PIL import Image

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")


def list_images(image_dir) -> List[Path]:
    paths = [p for p in sorted(Path(image_dir).iterdir()) if p.suffix.lower() in IMAGE_EXTS]
    if not paths:
        raise FileNotFoundError(f"no images found in {image_dir}")
    return paths


def load_image(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.float32)


def load_image_stack(image_dir) -> Tuple[np.ndarray, List[str]]:
    paths = list_images(image_dir)
    imgs = np.stack([load_image(p) for p in paths])
    return imgs, [p.name for p in paths]
