"""GOP-chunk encode/decode (port of the full-plane branch of
``basic_video_codec_tpu/models/chunk.py``): an optional leading I-frame,
then a Python loop over the chunk's P-frames with the reference kept on
the device."""

import torch

from ..ops.intra import intra_decode_frame, intra_encode_frame
from .pframe import pframe_decode, pframe_encode


def encode_chunk(frames: torch.Tensor, ref0: torch.Tensor, row_qps: torch.Tensor,
                 initial_qp: int, bs: int, search_range: int,
                 first_is_intra: bool, exact: bool = False):
    """Encode uint8 ``[K, H, W]`` frames; ``ref0`` is the incoming reference
    (used iff not ``first_is_intra``).

    Returns ``(intra_out | None, p_out | None, ref_out)`` with
    ``intra_out = (recon, art, qdct, smalls)`` for frames[0] and ``p_out``
    the same four fields stacked over the chunk's P-frames (None when the
    chunk is its I-frame alone)."""
    ref, intra_out, p_frames = ref0, None, frames
    if first_is_intra:
        recon, _, art, qdct, smalls = intra_encode_frame(
            frames[0], row_qps, initial_qp, bs, exact)
        intra_out = (recon, art, qdct, smalls)
        ref, p_frames = recon, frames[1:]
    outs = []
    for curr in p_frames:
        recon, _, art, qdct, smalls = pframe_encode(
            curr, ref, row_qps, initial_qp, bs, search_range, exact)
        outs.append((recon, art, qdct, smalls))
        ref = recon
    p_out = tuple(torch.stack(x) for x in zip(*outs)) if outs else None
    return intra_out, p_out, ref


def decode_chunk(qdcts: torch.Tensor, mvs: torch.Tensor, row_qps: torch.Tensor,
                 modes0: torch.Tensor, ref0: torch.Tensor, bs: int,
                 first_is_intra: bool, exact: bool = False):
    """Decode ``[K, H, W]`` quantized planes with their ``[K, nbr, nbc, 3]``
    MV fields and ``[K, nbr]`` row QPs (frame 0's MVs are ignored and its
    intra ``modes0`` used when ``first_is_intra``).  Returns
    ``(decoded [K, H, W], ref_out)``."""
    ref, decoded, start = ref0, [], 0
    if first_is_intra:
        ref, _ = intra_decode_frame(qdcts[0], modes0, row_qps[0], bs, exact)
        decoded.append(ref)
        start = 1
    for k in range(start, qdcts.shape[0]):
        ref, _ = pframe_decode(qdcts[k], mvs[k], row_qps[k], ref, bs, exact)
        decoded.append(ref)
    return torch.stack(decoded), ref
