"""Exact entropy bit lengths computed on the device (port of
``basic_video_codec_tpu/ops/bitlen.py``).

Exp-Golomb codeword lengths are closed-form (``2*bitlen(mapped+1) - 1``) and
the RLE run structure reduces to cumulative boolean ops, so the device
prices a block row without materialising a bit.  All outputs are int32.
"""

from functools import lru_cache

import torch

from ..entropy.zigzag import zigzag_indices


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Integer bit length of non-negative values (< 2^17), exact."""
    x = x.to(torch.int32)
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = x >> s
        has = hi > 0
        n = n + torch.where(has, s, 0).to(torch.int32)
        x = torch.where(has, hi, x)
    return n + (x > 0).to(torch.int32)


def golomb_len(values: torch.Tensor) -> torch.Tensor:
    """Signed exp-Golomb codeword length: ``2*bitlen(mapped+1) - 1``."""
    v = values.to(torch.int32)
    mapped = torch.where(v <= 0, -2 * v, 2 * v - 1)
    return 2 * _bitlen(mapped + 1) - 1


EOB_LEN = 27  # golomb_len(8190): mapped+1 = 16380, 14 bits -> 27


def rle_block_bits(zigzagged: torch.Tensor) -> torch.Tensor:
    """Exact RLE+exp-Golomb bit cost per block ``[..., L]`` scan, including
    the EOB marker:

    * every non-zero coefficient contributes its own codeword,
    * every non-zero run start contributes the ``-run_len`` header,
    * every zero run contributes ``run_len`` header — or the 1-bit ``0``
      terminator when the run reaches the end of the block.
    """
    z = zigzagged.to(torch.int32)
    L = z.shape[-1]
    nz = z != 0
    pos = torch.arange(L, dtype=torch.int32, device=z.device)

    # run starts: position 0 or zero/non-zero class change
    prev_nz = torch.cat([~nz[..., :1], nz[..., :-1]], dim=-1)
    start = nz != prev_nz
    start[..., 0] = True

    # next run start at or after each position: reversed running minimum
    start_pos = torch.where(start, pos, L).to(torch.int32)
    nxt = torch.cummin(start_pos.flip(-1), dim=-1).values.flip(-1)
    nxt_after = torch.cat([nxt[..., 1:], torch.full_like(nxt[..., :1], L)],
                          dim=-1)  # first start strictly after this position
    run_len = nxt_after - pos  # valid at start positions

    lit_bits = torch.where(nz, golomb_len(z), 0)
    nz_header = golomb_len(-run_len)
    zero_header_val = torch.where(nxt_after == L, 0, run_len)
    zero_header = golomb_len(zero_header_val)
    header_bits = torch.where(start, torch.where(nz, nz_header, zero_header), 0)
    return ((lit_bits + header_bits).sum(dim=-1, dtype=torch.int32)
            + EOB_LEN)


@lru_cache(maxsize=None)
def _zigzag_index(bs: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(zigzag_indices(bs)).to(device)


def zigzag_rows(blocks_flat: torch.Tensor, bs: int) -> torch.Tensor:
    """``[..., bs*bs]`` flattened int blocks -> int32 zigzag scans (a gather)."""
    idx = _zigzag_index(bs, blocks_flat.device)
    return blocks_flat.to(torch.int32).index_select(-1, idx)


def intra_mode_bits(modes: torch.Tensor) -> torch.Tensor:
    """Per-block intra mode codeword length (mode 0 -> 1 bit, 1 -> 3 bits)."""
    return torch.where(modes == 0, 1, 3).to(torch.int32)
