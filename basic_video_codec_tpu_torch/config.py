"""Run configuration, field for field the JAX package's
(``basic_video_codec_tpu/config.py``), plus where the run executes.

``EncoderConfig`` holds the encoder knobs and ``InputParameters`` describes
one encode/decode run.  The keyword-only fields are this package's own:

* ``exact_transform`` — integer-exact DCT/IDCT: streams become
  bit-identical across backends and devices.  Streams encoded with it must
  be decoded with it.
* ``device`` — the torch device the codec runs on.  ``"cuda"`` by default;
  without a card the entry points raise rather than run on the CPU.  Pass
  ``"cpu"`` to run on the CPU deliberately.
"""

import math


class EncoderConfig:
    """All encoder knobs."""

    def __init__(
        self,
        block_size,
        search_range,
        I_Period,
        quantization_factor,
        nRefFrames=1,
        fastME=False,
        fracMeEnabled=False,
        RCflag=0,
        targetBR=0,
        resolution=(352, 288),
        *,
        exact_transform=False,
        device="cuda",
    ):
        self.block_size = block_size
        self.search_range = search_range
        self.quantization_factor = quantization_factor
        self.I_Period = I_Period
        self.nRefFrames = nRefFrames
        self.fastME = fastME
        self.fracMeEnabled = fracMeEnabled
        self.RCflag = RCflag
        self.targetBR = targetBR
        self.resolution = resolution
        self.exact_transform = exact_transform
        self.device = device
        self.validate()

    def validate(self):
        """Constraint checks.

        * QP must satisfy ``qp <= log2(block_size) + 7``.
        * Rate control needs a non-zero target bitrate.
        * fastME forces ``search_range = -1`` (the sentinel used in artifact
          names and the results log).
        """
        if self.quantization_factor > (math.log2(self.block_size) + 7):
            raise ValueError(
                f" qp [{self.quantization_factor}] > {math.log2(self.block_size) + 7}"
            )
        if self.RCflag:
            if self.targetBR == 0:
                raise ValueError("Target Bit Rate is 0 when Rate Control is On")
        if self.fastME:
            self.search_range = -1
        return self


class InputParameters:
    """Descriptor of one encode/decode run."""

    def __init__(
        self,
        y_only_file,
        width,
        height,
        encoder_config: EncoderConfig,
        frames_to_process=12,
        yuv_file=None,
    ):
        self.yuv_file = yuv_file
        self.y_only_file = y_only_file
        self.width = width
        self.height = height
        self.frames_to_process = frames_to_process
        self.encoder_config = encoder_config
