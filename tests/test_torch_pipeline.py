"""The PyTorch port's slice end to end against the JAX package: encode and
decode one synthetic clip with both, compare the artifact trees, and check
the port's own rules (device selection, imports)."""

import ast
import csv
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import basic_video_codec_tpu as J
import basic_video_codec_tpu_torch as P
from basic_video_codec_tpu.tools import ygen
from basic_video_codec_tpu_torch.convert import config_from_reference, params_from_reference

W, H, N = 64, 48, 8
SUBDIR = "8_2_4_4_1_0_0"  # bs 8, r 2, QP 4, I_Period 4, one ref, RC off
BYTE_FILES = ("encoded.bin", "mv.txt", "mc_reconstructed.yuv", "mc_decoded.yuv",
              "residuals_w_mc.yuv", "residuals_wo_mc.yuv", "mc_quant_dct_coff.bin")


def _ref_params(path, exact):
    ec = J.EncoderConfig(8, 2, 4, 4, resolution=(W, H), exact_transform=exact)
    return J.InputParameters(str(path), W, H, ec, frames_to_process=N)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{exact: (jax artifact dir, port artifact dir)} for both transforms."""
    src = tmp_path_factory.mktemp("clip")
    ygen.write_y_file(str(src / "seq.y"), ygen.moving_sequence(W, H, N, seed=3))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's full-plane lane, the one the port mirrors
        mp.setenv("BVC_COMPACT", "0")
        mp.setenv("BVC_DCOMPACT", "0")
        for exact in (True, False):
            dirs = []
            for name in ("jax", "torch"):
                d = tmp_path_factory.mktemp(f"{name}_{exact}")
                shutil.copy(src / "seq.y", d / "seq.y")
                p = _ref_params(d / "seq.y", exact)
                if name == "jax":
                    J.encode_video(p, results_csv_path=None)
                    J.decode_video(p)
                else:
                    pt = params_from_reference(p, device="cpu")
                    P.encode_video(pt, results_csv_path=None)
                    P.decode_video(pt)
                dirs.append(d / "seq" / SUBDIR)
            out[exact] = tuple(dirs)
    return out


def _metrics(d):
    with open(d / "metrics.csv", newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("name", BYTE_FILES)
def test_exact_artifacts_byte_identical(trees, name):
    jd, td = trees[True]
    assert (jd / name).read_bytes() == (td / name).read_bytes()


def test_exact_metrics_identical_but_times(trees):
    jd, td = trees[True]
    a, b = _metrics(jd), _metrics(td)
    assert a[0] == b[0] and len(a) == len(b) == N + 1
    keep = [i for i, c in enumerate(a[0]) if c not in ("enc_time", "elapsed_time")]
    assert [[r[i] for i in keep] for r in a] == [[r[i] for i in keep] for r in b]


def test_float_mode_within_parity_class(trees):
    """PARITY.md's float-DCT class: per-frame PSNR within 0.06 dB and
    encoded size within 0.5%."""
    jd, td = trees[False]
    a, b = _metrics(jd)[1:], _metrics(td)[1:]
    col = _metrics(jd)[0].index("PSNR")
    assert len(a) == len(b) == N
    for ra, rb in zip(a, b):
        assert abs(float(ra[col]) - float(rb[col])) <= 0.06
    sa, sb = (jd / "encoded.bin").stat().st_size, (td / "encoded.bin").stat().st_size
    assert abs(sa - sb) <= 0.005 * sa


@pytest.mark.parametrize("exact", [True, False])
def test_port_decode_equals_recon(trees, exact):
    td = trees[exact][1]
    dec = (td / "mc_decoded.yuv").read_bytes()
    assert len(dec) == W * H * N and dec == (td / "mc_reconstructed.yuv").read_bytes()


@pytest.mark.parametrize("W_,H_,n,i_period", [
    (64, 48, 3, 1),     # every chunk is an I-frame alone
    (60, 44, 26, 26),   # padded to block multiples; a GOP split into chunks
])
def test_exact_edge_configs_byte_identical(tmp_path, monkeypatch, W_, H_, n, i_period):
    monkeypatch.setenv("BVC_COMPACT", "0")
    monkeypatch.setenv("BVC_DCOMPACT", "0")
    trees = []
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
        path = tmp_path / name / "seq.y"
        ygen.write_y_file(str(path), ygen.moving_sequence(W_, H_, n, seed=4))
        ec = J.EncoderConfig(8, 2, i_period, 3, resolution=(W_, H_),
                             exact_transform=True)
        p = J.InputParameters(str(path), W_, H_, ec, frames_to_process=n)
        if name == "jax":
            J.encode_video(p, results_csv_path=None)
            J.decode_video(p)
        else:
            pt = params_from_reference(p, device="cpu")
            P.encode_video(pt, results_csv_path=None)
            P.decode_video(pt)
        trees.append(tmp_path / name / "seq" / f"8_2_3_{i_period}_1_0_0")
    for f in BYTE_FILES:
        assert (trees[0] / f).read_bytes() == (trees[1] / f).read_bytes(), f


def test_config_from_reference_copies_every_field():
    ec = J.EncoderConfig(16, 3, 7, 9, 2, False, True, 1, 4000, (176, 144),
                         exact_transform=True)
    pc = config_from_reference(ec, device="cpu")
    for name in ("block_size", "search_range", "I_Period", "quantization_factor",
                 "nRefFrames", "fastME", "fracMeEnabled", "RCflag", "targetBR",
                 "resolution", "exact_transform"):
        assert getattr(pc, name) == getattr(ec, name), name
    assert pc.device == "cpu"


def test_default_device_raises_without_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ygen.write_y_file(str(tmp_path / "s.y"), ygen.moving_sequence(16, 16, 1))
    ec = P.EncoderConfig(8, 1, 1, 3, resolution=(16, 16))
    assert ec.device == "cuda"
    params = P.InputParameters(str(tmp_path / "s.y"), 16, 16, ec, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.encode_video(params, results_csv_path=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.decode_video(params)


def test_configs_outside_the_slice_raise(tmp_path):
    ygen.write_y_file(str(tmp_path / "s.y"), ygen.moving_sequence(16, 16, 1))
    for kw in (dict(fastME=True), dict(fracMeEnabled=True), dict(nRefFrames=2),
               dict(RCflag=1, targetBR=1000)):
        ec = P.EncoderConfig(8, 1, 1, 3, resolution=(16, 16), device="cpu", **kw)
        params = P.InputParameters(str(tmp_path / "s.y"), 16, 16, ec, 1)
        with pytest.raises(NotImplementedError):
            P.encode_video(params, results_csv_path=None)


def test_port_imports_neither_jax_nor_the_reference():
    root = Path(P.__file__).parent
    sources = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "basic_video_codec_tpu"), (
                    f"{path}: imports {n}")
