"""Python wrapper over the C++ image decoder (``native/image_decode.cpp``:
libjpeg/libpng decode and bilinear resize)."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from mpmc_tpu_torch import native_lib


def available() -> bool:
    return native_lib.load("image_decode") is not None


def decode_resize(path: str, size: int, grayscale: bool = False
                  ) -> Optional[np.ndarray]:
    """Decode and resize to uint8 ``[size, size, C]``; None if the library
    is absent or the file undecodable."""
    lib = native_lib.load("image_decode")
    if lib is None:
        return None
    c = 1 if grayscale else 3
    out = np.empty((size, size, c), dtype=np.uint8)
    ok = lib.img_decode_resize(
        path.encode(), size, int(grayscale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if ok else None


def lib_versions() -> Optional[Tuple[int, str]]:
    """``(JPEG_LIB_VERSION compiled against, libpng version loaded)``;
    None without the library."""
    lib = native_lib.load("image_decode")
    if lib is None:
        return None
    return lib.img_jpeg_lib_version(), lib.img_png_version().decode()
