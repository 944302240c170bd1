"""Frame readers (counterpart of ``pips_tpu/data/pfm.py``): the PFM reader
(the format FlyingThings uses for object-index masks and flows: header
'PF'/'Pf', dims, scale whose sign is the endianness, rows bottom-up),
``read_image_or_pfm`` as in the JAX package, and ``read_image``, the one
decoder of compressed frames (webp, jpg, png) that every reader of the port
calls, through PIL as the JAX package's readers decode them."""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).copy()


def read_image_or_pfm(path: str) -> np.ndarray:
    if path.lower().endswith(".pfm"):
        data = read_pfm(path)
        return data[:, :, :3] if data.ndim == 3 else data
    import imageio.v2 as imageio
    return imageio.imread(path)


def read_image(path: str) -> np.ndarray:
    """Decode a compressed frame into a numpy array (as ``np.array`` of the
    PIL image: (H, W, 3) uint8 for RGB, (H, W) for one channel)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs PIL (Pillow), the port's image decoder") from e
    with Image.open(path) as im:
        return np.array(im)
