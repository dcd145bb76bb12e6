"""Artifact tree naming and frame writers.

The output directory for a run is
``<seq>/<bs>_<sr>[.0]_<qp>_<IPeriod>_<nRef>_<RCflag>_<targetBR>/`` and holds
``mv.txt``, ``metrics.csv``, ``residuals_w_mc.yuv``, ``residuals_wo_mc.yuv``,
``mc_quant_dct_coff.bin``, ``encoded.bin``, ``mc_reconstructed.yuv`` and
``mc_decoded.yuv`` — the same tree, byte for byte, as the JAX package's.
"""

import contextlib
import os

import numpy as np

from ..config import InputParameters


@contextlib.contextmanager
def overwrite_open(path: str, text: bool = False, newline=None):
    """``open(path, "w")`` semantics without truncate-at-open: an existing
    file is overwritten in place and truncated to the new length at exit.

    Truncating at open makes ext4 (data=ordered) first write back the dirty
    pages the file still holds from a previous run; in-place overwrites
    carry no such ordering.  On error the file is truncated at the failure
    point, so a crashed run leaves a plain prefix, not a prefix plus a
    stale tail."""
    mode = "r+" if text else "r+b"
    try:
        fh = open(path, mode, newline=newline) if text else open(path, mode)
    except FileNotFoundError:
        fh = (open(path, "w", newline=newline) if text
              else open(path, "wb"))
    try:
        yield fh
    except BaseException:
        # already raising: truncate best-effort, don't mask the original
        with contextlib.suppress(OSError, ValueError):
            fh.truncate()
        fh.close()
        raise
    else:
        try:
            fh.truncate()  # must succeed: a stale tail would corrupt artifacts
        finally:
            fh.close()


class FileIOHelper:
    """Derives every artifact path for a run."""

    def __init__(self, params: InputParameters):
        ec = params.encoder_config
        fme_id = ".0" if ec.fracMeEnabled else ""
        # 7-field config identity
        self.file_identifier = (
            f"{ec.block_size}_{ec.search_range}{fme_id}_{ec.quantization_factor}_"
            f"{ec.I_Period}_{ec.nRefFrames}_{ec.RCflag}_{ec.targetBR}"
        )
        self.file_prefix = os.path.splitext(params.y_only_file)[0]
        os.makedirs(os.path.dirname(self.get_file_name(suffix="")), exist_ok=True)

    def get_file_name(self, suffix):
        return f"{self.file_prefix}/{self.file_identifier}/{suffix}"

    def get_mv_file_name(self):
        return self.get_file_name("mv.txt")

    def get_metrics_csv_file_name(self):
        return self.get_file_name("metrics.csv")

    def get_residual_w_mc_file_name(self):
        return self.get_file_name("residuals_w_mc.yuv")

    def get_residual_wo_mc_file_name(self):
        return self.get_file_name("residuals_wo_mc.yuv")

    def get_quant_dct_coff_fh_file_name(self):
        return self.get_file_name("mc_quant_dct_coff.bin")

    def get_encoded_file_name(self):
        return self.get_file_name("encoded.bin")

    def get_mc_reconstructed_file_name(self):
        return self.get_file_name("mc_reconstructed.yuv")

    def get_mc_decoded_file_name(self):
        return self.get_file_name("mc_decoded.yuv")


def write_y_only_frame(file_handle, frame: np.ndarray):
    """Raw plane dump, straight from the array's buffer when contiguous."""
    if frame.flags.c_contiguous:
        file_handle.write(frame.data)
    else:
        file_handle.write(frame.tobytes())
