"""Per-frame metrics record: column order ``idx, I-Frame, avg_MAE,
mae_comps, PSNR, frame_bytes, file_bits, enc_time, elapsed_time`` with
two-decimal formatting on the float columns."""

from dataclasses import dataclass, fields


@dataclass
class FrameMetrics:
    idx: int
    is_i_frame: bool
    avg_mae: float
    mae_comps: int
    psnr: float
    frame_bytes: int
    file_bits: int
    encoding_time: float
    elapsed_time: float

    HEADER = ("idx", "I-Frame", "avg_MAE", "mae_comps", "PSNR",
              "frame_bytes", "file_bits", "enc_time", "elapsed_time")

    # which dataclass fields are serialized as %.2f strings
    _FLOAT_COLS = frozenset({"avg_mae", "psnr", "encoding_time", "elapsed_time"})

    def to_csv_row(self) -> list:
        row = []
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name == "is_i_frame":
                row.append(1 if v else 0)
            elif f.name in self._FLOAT_COLS:
                row.append(f"{v:.2f}")
            else:
                row.append(v)
        return row

    @staticmethod
    def get_header() -> list:
        return list(FrameMetrics.HEADER)
