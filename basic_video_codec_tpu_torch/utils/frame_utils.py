"""Host frame helpers: padding to block multiples and PSNR."""

import numpy as np

from ..entropy import native
from .logger import get_logger

logger = get_logger()


def padded_dims(width: int, height: int, block_size: int) -> tuple[int, int]:
    """(width, height) rounded up to block multiples — the dimensions every
    plane has after :func:`pad_frame`."""
    return (
        width + (block_size - width % block_size) % block_size,
        height + (block_size - height % block_size) % block_size,
    )


def pad_frame(frame: np.ndarray, block_size: int, pad_value: int = 128) -> np.ndarray:
    """Pad bottom/right to a block multiple with ``pad_value``."""
    height, width = frame.shape
    pad_h = (block_size - (height % block_size)) % block_size
    pad_w = (block_size - (width % block_size)) % block_size
    if pad_h or pad_w:
        logger.warning(f"frame is padded [{pad_h} , {pad_w}]")
        padded = np.full((height + pad_h, width + pad_w), pad_value, dtype=np.uint8)
        padded[:height, :width] = frame
        return padded
    return frame


def psnr(im_true: np.ndarray, im_test: np.ndarray, data_range: float = 255.0) -> float:
    """``10*log10(range^2 / mse)`` of two u8 planes, MSE in float64 (the
    integer SSE over the pixel count is exact in float64)."""
    err = native.sse(im_true, im_test) / im_true.size
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / err))
