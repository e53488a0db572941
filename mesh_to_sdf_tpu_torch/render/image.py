"""Image output helpers: float [0, 1] → uint8, and PNG files written with
the standard library (``io.png``), so saving needs no imaging package."""
from __future__ import annotations

import numpy as np
import torch

from ..io import png


def host_array(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor on any device is copied to the
    host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_uint8(img) -> np.ndarray:
    arr = host_array(img)
    arr = np.clip(arr, 0.0, 1.0)
    return (arr * 255.0 + 0.5).astype(np.uint8)


def save_png(path, img) -> None:
    """Save an (H, W, 3) float [0,1] or uint8 image as PNG."""
    arr = host_array(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    with open(path, "wb") as fh:
        fh.write(png.encode_rgb8(arr))
