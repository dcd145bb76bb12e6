"""Synthetic Y-only test video: a textured frame translated by a
deterministic shift pattern, so motion-estimation answers are known."""

import numpy as np


def textured_frame(width: int, height: int, seed: int = 0) -> np.ndarray:
    """Deterministic textured frame: diagonal gradient, disc, triangle, ripple."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    base = (xx * 0.7 + yy * 0.5) % 256.0

    cx, cy, r = width * 0.35, height * 0.4, min(width, height) * 0.22
    disc = ((xx - cx) ** 2 + (yy - cy) ** 2) <= r * r
    base[disc] = (base[disc] + 96.0) % 256.0

    tri = (xx + yy * 0.8 > width * 0.9) & (xx - yy * 1.2 < width * 0.6)
    base[tri] = 255.0 - base[tri]

    ripple = 14.0 * np.sin(xx / 6.3 + seed) * np.cos(yy / 4.7 - seed * 0.5)
    return np.clip(base + ripple, 0, 255).astype(np.uint8)


_SHIFTS = [0, 2, 4, 8, 16, 32]


def moving_sequence(width: int, height: int, n_frames: int, seed: int = 0) -> np.ndarray:
    """``[N, H, W]`` uint8: a textured frame translated by a deterministic
    pattern — shift magnitude cycles ``_SHIFTS``, direction cycles
    horizontal / vertical / diagonal."""
    base = textured_frame(width, height, seed)
    frames = [base]
    dx = dy = 0
    for i in range(1, n_frames):
        mag = _SHIFTS[i % len(_SHIFTS)]
        direction = i % 3
        if direction == 0:
            dx += mag
        elif direction == 1:
            dy += mag
        else:
            dx += mag
            dy += mag
        frames.append(np.roll(np.roll(base, dy, axis=0), dx, axis=1))
    return np.stack(frames)


def write_y_file(path: str, frames: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(frames, dtype=np.uint8).tobytes())
    return path
