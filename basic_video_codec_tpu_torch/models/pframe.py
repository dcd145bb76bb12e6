"""P-frame encode/decode (port of the fixed-QP, full-search, single-reference
branch of ``basic_video_codec_tpu/models/pframe.py``).

1. full-search motion estimation with fused MC prediction (the CUDA kernel
   on the card, its plain version on the CPU: ops/full_search_cuda.py),
2. residuals -> batched DCT,
3. quantization at each row's QP + exact entropy pricing of every row
   (differential-MV codes, qp_diff and the RLE/exp-Golomb DCT payload),
4. batched rescale/IDCT/reconstruct.
"""

import torch

from ..ops import bitlen
from ..ops import transform as T
from ..ops.full_search_cuda import full_search
from ..ops.intra import blocks_to_plane
from ..ops.me import gather_pred_blocks


def _wrap_int8_bits(x: torch.Tensor) -> torch.Tensor:
    """Float -> int8 modular cast, as the uint8 bit pattern: truncate, then
    floor-modulo 256 (artifact planes only)."""
    t = torch.trunc(x).to(torch.int32)
    return (t % 256).to(torch.uint8)


def pframe_encode(curr: torch.Tensor, ref: torch.Tensor, row_qps: torch.Tensor,
                  initial_qp: int, bs: int, search_range: int,
                  exact: bool = False):
    """Encode uint8 ``[H, W]`` ``curr`` against the reconstructed ``ref``.

    Returns ``(recon_u8 [H, W], None, art_u8 [H, W] (res_w_mc bit plane),
    qdct_i16 [H, W], smalls_i32)`` — smalls pack (mvs, sads, comps,
    row_qps, row_bits)."""
    h, w = curr.shape
    nbr, nbc = h // bs, w // bs
    dev = curr.device
    qmats = T.quant_table(bs, dev)

    mvs, sads, preds = full_search(curr, ref[None], None, bs, search_range,
                                   False)
    comps = torch.full((nbr, nbc), (2 * search_range + 1) ** 2,
                       dtype=torch.int32, device=dev)

    curr_blocks = curr.reshape(nbr, bs, nbc, bs).transpose(1, 2).to(torch.int32)
    coeffs = T.forward_coeffs(curr_blocks - preds, bs, exact)

    # differential-MV codes run raster across the whole frame
    flat_mvs = mvs.reshape(-1, 3)
    prev = torch.cat([torch.zeros((1, 3), dtype=torch.int32, device=dev),
                      flat_mvs[:-1]])
    diffs = flat_mvs - prev
    mv_bits = bitlen.golomb_len(diffs[:, 0]) + bitlen.golomb_len(diffs[:, 1])
    mv_row_bits = mv_bits.reshape(nbr, nbc).sum(dim=1, dtype=torch.int32)

    Qr = qmats[row_qps.long()][:, None]  # [nbr, 1, bs, bs]
    q = T.quantize(coeffs, Qr)
    qrows = q.to(torch.int16)
    zz_rows = bitlen.zigzag_rows(qrows.reshape(nbr, nbc, bs * bs), bs)
    row_bits = (bitlen.rle_block_bits(zz_rows).sum(dim=1, dtype=torch.int32)
                + bitlen.golomb_len(row_qps - initial_qp) + mv_row_bits)

    recon_blocks, idct_res = T.reconstruct_mode(qrows, Qr, preds, bs, exact)
    smalls = torch.cat([mvs.reshape(-1), sads.reshape(-1), comps.reshape(-1),
                        row_qps.to(torch.int32), row_bits])
    return (blocks_to_plane(recon_blocks), None, blocks_to_plane(_wrap_int8_bits(idct_res)),
            blocks_to_plane(qrows), smalls)


def pframe_decode(qdct: torch.Tensor, mvs: torch.Tensor, row_qps: torch.Tensor,
                  ref: torch.Tensor, bs: int, exact: bool = False):
    """Reconstruct a P-frame from its quantized DCT plane, MV field
    ``[nbr, nbc, 3]`` and row QPs.  Returns ``(decoded_u8 [H, W], None)``."""
    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    preds = gather_pred_blocks(ref[None], mvs, bs)
    qblocks = qdct.reshape(nbr, bs, nbc, bs).transpose(1, 2)
    Qr = T.quant_table(bs, qdct.device)[row_qps.long()][:, None]
    recon_blocks, _ = T.reconstruct_mode(qblocks, Qr, preds, bs, exact)
    return blocks_to_plane(recon_blocks), None
