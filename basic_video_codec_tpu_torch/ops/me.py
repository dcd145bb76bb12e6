"""Full-search motion estimation, plain PyTorch (port of
``basic_video_codec_tpu/ops/me.py``).

:func:`full_search` is the CPU path and the reference that the CUDA kernel
(``ops/full_search_cuda.py``) is held against on the card.  Every candidate
displacement is scored for all blocks of the frame at once; the winner per
block is the first strict minimum of the packed key
``SAD * 256 + |mv_x| + |mv_y|`` in the enumeration order ref-major, then
mv_y, then mv_x.  Out-of-frame candidates are masked.  With half-pel search
the range doubles and reads are stride 2 in the ``[2H, 2W]`` half-pel plane.
"""

import numpy as np
import torch

INVALID_KEY = 2 ** 30


def candidate_offsets(n_ref: int, search_range: int) -> np.ndarray:
    """Candidate table in enumeration order (ref-major, mv_y ascending,
    mv_x ascending).  Returns int32 ``[n_cand, 3]`` rows ``(ref, mv_y, mv_x)``."""
    span = 2 * search_range + 1
    k = np.repeat(np.arange(n_ref), span * span)
    dy = np.tile(np.repeat(np.arange(-search_range, search_range + 1), span), n_ref)
    dx = np.tile(np.arange(-search_range, search_range + 1), span * n_ref)
    return np.stack([k, dy, dx], axis=1).astype(np.int32)


def check_args(curr, refs, interp_refs, bs, search_range, frac, n_valid):
    """Validate the inputs shared by the plain version and the kernel;
    returns the effective search range and the searched planes."""
    sr = search_range * 2 if frac else search_range
    if not 0 <= sr <= 127:
        raise ValueError(f"search range {sr} outside [0, 127]: the packed "
                         f"(SAD, L1) key holds L1 in 8 bits")
    if curr.dim() != 2 or refs.dim() != 3:
        raise ValueError(f"curr must be [H, W] and refs [n_ref, H, W], got "
                         f"{tuple(curr.shape)} and {tuple(refs.shape)}")
    h, w = curr.shape
    n_ref = refs.shape[0]
    if h % bs or w % bs or tuple(refs.shape[1:]) != (h, w) or n_ref < 1:
        raise ValueError(f"frame {h}x{w} / refs {tuple(refs.shape)} do not "
                         f"match block size {bs}")
    planes = refs
    if frac:
        if interp_refs is None or tuple(interp_refs.shape) != (n_ref, 2 * h, 2 * w):
            raise ValueError("frac search needs half-pel planes [n_ref, 2H, 2W]")
        planes = interp_refs
    if n_valid is not None and not 1 <= n_valid <= n_ref:
        raise ValueError(f"n_valid {n_valid} outside [1, {n_ref}]")
    for name, t in (("curr", curr), ("planes", planes)):
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, got {t.dtype}")
        if t.device != curr.device:
            raise ValueError(f"{name} on {t.device}, curr on {curr.device}")
    return sr, planes


def full_search(curr: torch.Tensor, refs: torch.Tensor, interp_refs,
                bs: int, search_range: int, frac: bool, n_valid: int | None = None):
    """Exhaustive block search with motion-compensated prediction.

    Parameters
    ----------
    curr : uint8 ``[H, W]`` current frame
    refs : uint8 ``[n_ref, H, W]`` reference frames (0 = oldest)
    interp_refs : uint8 ``[n_ref, 2H, 2W]`` half-pel planes (used iff frac;
        may be None otherwise)
    search_range : the config search range; doubled internally when frac
    n_valid : optional number of leading reference slots that hold real
        frames; candidates of later slots are masked out.

    Returns ``(mvs int32 [nbr, nbc, 3] as (mv_x, mv_y, ref),
    sad int32 [nbr, nbc], pred int32 [nbr, nbc, bs, bs])``.
    """
    sr, planes = check_args(curr, refs, interp_refs, bs, search_range, frac,
                            n_valid)
    h, w = curr.shape
    nbr, nbc = h // bs, w // bs
    n_ref = refs.shape[0]
    dev = curr.device
    scale = 2 if frac else 1
    # zero border of sr: candidate (dy, dx) of plane k is a plain slice of
    # the padded plane; its out-of-frame pixels only reach masked candidates
    pad = torch.nn.functional.pad(planes.to(torch.int32), (sr, sr, sr, sr))
    curr_i = curr.to(torch.int32)
    ox = torch.arange(nbc, dtype=torch.int32, device=dev) * bs * scale
    oy = torch.arange(nbr, dtype=torch.int32, device=dev) * bs * scale
    lim_w, lim_h, bspan = w * scale, h * scale, bs * scale

    best_key = torch.full((nbr, nbc), INVALID_KEY, dtype=torch.int32, device=dev)
    best_sad = torch.zeros((nbr, nbc), dtype=torch.int32, device=dev)
    best_cand = torch.zeros((nbr, nbc, 3), dtype=torch.int32, device=dev)
    pred = torch.zeros((nbr, nbc, bs, bs), dtype=torch.int32, device=dev)
    for k, dy, dx in candidate_offsets(n_ref, sr).tolist():
        aligned = pad[k, sr + dy : sr + dy + h * scale : scale,
                      sr + dx : sr + dx + w * scale : scale]
        blocks = aligned.reshape(nbr, bs, nbc, bs).transpose(1, 2)
        sad = (curr_i - aligned).abs().reshape(nbr, bs, nbc, bs).sum(
            dim=(1, 3), dtype=torch.int32)
        valid = (((ox + dx >= 0) & (ox + dx + bspan <= lim_w))[None, :]
                 & ((oy + dy >= 0) & (oy + dy + bspan <= lim_h))[:, None])
        if n_valid is not None and k >= n_valid:
            valid = torch.zeros_like(valid)
        key = torch.where(valid, sad * 256 + (abs(dx) + abs(dy)), INVALID_KEY)
        take = key < best_key  # strict: the FIRST minimum wins
        best_key = torch.where(take, key, best_key)
        best_sad = torch.where(take, sad, best_sad)
        best_cand = torch.where(
            take[..., None],
            torch.tensor([dx, dy, k], dtype=torch.int32, device=dev),
            best_cand)
        pred = torch.where(take[..., None, None], blocks, pred)
    return best_cand, best_sad, pred


def gather_pred_blocks(refs: torch.Tensor, mvs: torch.Tensor, bs: int) -> torch.Tensor:
    """Integer-pel motion-compensated prediction for every block, one gather:
    ``pred[i, j, a, b] = refs[k, i*bs + mv_y + a, j*bs + mv_x + b]``.
    Returns int32 ``[nbr, nbc, bs, bs]``."""
    nbr, nbc = mvs.shape[:2]
    dev = refs.device
    mvs = mvs.to(device=dev, dtype=torch.int64)
    a = torch.arange(bs, device=dev)
    oy = (torch.arange(nbr, device=dev) * bs)[:, None, None, None]
    ox = (torch.arange(nbc, device=dev) * bs)[None, :, None, None]
    rows = oy + mvs[..., 1][..., None, None] + a[None, None, :, None]
    cols = ox + mvs[..., 0][..., None, None] + a[None, None, None, :]
    return refs[mvs[..., 2][..., None, None], rows, cols].to(torch.int32)
