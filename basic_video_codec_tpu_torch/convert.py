"""Configuration carried over from the JAX package.

The codec has no learned weights: the state both packages share is the
encoder configuration (below) and the transform tables, which
``ops/transform.py`` computes with the same formulas as the JAX package.
Both functions read attributes with ``getattr``, so they take the JAX
package's objects without importing it.
"""

from .config import EncoderConfig, InputParameters

_FIELDS = ("block_size", "search_range", "I_Period", "quantization_factor",
           "nRefFrames", "fastME", "fracMeEnabled", "RCflag", "targetBR",
           "resolution")


def config_from_reference(ec, *, device="cuda") -> EncoderConfig:
    """This package's ``EncoderConfig`` from any object with the reference
    ``EncoderConfig``'s attributes."""
    return EncoderConfig(
        *(getattr(ec, name) for name in _FIELDS),
        exact_transform=getattr(ec, "exact_transform", False),
        device=device,
    )


def params_from_reference(p, *, device="cuda") -> InputParameters:
    """This package's ``InputParameters`` from any object with the reference
    ``InputParameters``' attributes."""
    return InputParameters(
        p.y_only_file, p.width, p.height,
        config_from_reference(p.encoder_config, device=device),
        frames_to_process=p.frames_to_process, yuv_file=p.yuv_file,
    )
