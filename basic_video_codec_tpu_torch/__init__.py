"""basic_video_codec_tpu_torch — the PyTorch/CUDA port of basic_video_codec_tpu.

The JAX package ``basic_video_codec_tpu`` is the reference this port is held
against; this package imports nothing from it.  Its entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU, and raise when
no card is present.

This slice runs the fixed-QP, full-search, single-reference path: intra
wavefront, P-frames with full-search ME in a hand-written CUDA kernel
(``csrc/full_search.cu``), the float or integer-exact transform, and host
entropy coding into the same 7-file artifact tree as the JAX package.
"""

from .config import EncoderConfig, InputParameters
from .models.pipeline import decode_video, encode_video
from .ops.full_search_cuda import LAUNCHES

__all__ = [
    "EncoderConfig",
    "InputParameters",
    "encode_video",
    "decode_video",
    "LAUNCHES",
]
