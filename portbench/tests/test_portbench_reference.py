"""The plain reference against the program on the CPU at a tiny size: container bytes,
reconstructions and decoded frames, for both configurations; its own RLE against the
program's; the control's float32 transforms against the exact ones."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import REPO, TINY
from portbench.harness.generator import segment_pool
from portbench.reference import ReferenceEncoder
from portbench.reference.container import rle_encode_blocks
from portbench.reference.transform import dct2_float32, dct2_int, idct2_float32, idct2_int
from streamoptima_tpu_torch import CodecConfig, VideoCodec
from streamoptima_tpu_torch.core.zigzag import rle_encode_block

CONFIGS = ["main-720p", "fast-vbs-fme-720p"]
TRAFFIC = json.loads((REPO / "portbench/traffic/segments-encode.json").read_text())


def tiny_cfg(name: str, **over) -> dict:
    cfg = json.loads((REPO / f"portbench/configs/{name}.json").read_text())["codec"]
    cfg.update(TINY, **over)
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [1, 2**33 + 7])
def test_reference_equals_program(name, seed, tmp_path):
    cfg = tiny_cfg(name)
    pool = segment_pool(cfg["height"], cfg["width"], TRAFFIC, seed)
    ref = ReferenceEncoder(cfg, "cpu")
    for slot in (0, 5):
        frames = pool[slot]["frames"]
        codec = VideoCodec(CodecConfig(**cfg), frames, device="cpu")
        pkg = codec.encode(compute_ssim=False, package=False)
        path = tmp_path / f"{slot}.sob"
        codec.transmit_bitstream_binary(path)
        ref_bytes, ref_recon = ref.encode(frames)
        assert path.read_bytes() == ref_bytes
        assert np.array_equal(pkg["reconstructed frames"], ref_recon)
        path.write_bytes(ref_bytes)
        decoded = VideoCodec(CodecConfig(**cfg), device="cpu").decode_bitstream_binary(path)
        assert np.array_equal(decoded, ref_recon)


@pytest.mark.parametrize("over", [dict(n_ref_frames=3), dict(vbs_enable=True), dict(fme_enable=True),
                                  dict(fast_me=True, search_range=16)])
def test_reference_equals_program_on_other_tool_sets(over, tmp_path):
    cfg = tiny_cfg("main-720p", **over)
    frames = segment_pool(cfg["height"], cfg["width"], TRAFFIC, 3)[2]["frames"]
    codec = VideoCodec(CodecConfig(**cfg), frames, device="cpu")
    pkg = codec.encode(compute_ssim=False, package=False)
    codec.transmit_bitstream_binary(tmp_path / "c.sob")
    ref_bytes, ref_recon = ReferenceEncoder(cfg, "cpu").encode(frames)
    assert (tmp_path / "c.sob").read_bytes() == ref_bytes
    assert np.array_equal(pkg["reconstructed frames"], ref_recon)


def test_reference_refuses_what_it_does_not_run():
    """Rate control it runs (``test_portbench_reference_rc.py``); an ROI map, a parallel mode and
    intra mode 1 it refuses, and rate control without its rate."""
    for over in (dict(roi_qp_map=[0] * 12), dict(parallel_mode=2), dict(intra_mode=1), dict(rc_flag=1)):
        with pytest.raises(ValueError):
            ReferenceEncoder(tiny_cfg("main-720p", **over), "cpu")


@pytest.mark.parametrize("n", [4, 8, 16])
def test_rle_equals_program_rle(n):
    rng = np.random.default_rng(n)
    blocks = rng.integers(-3, 4, (300, n, n)) * (rng.random((300, n, n)) < rng.random((300, 1, 1)))
    blocks[0] = 0
    blocks[1] = 5
    blocks[2, -1, -1] = 7  # nonzero at the scan's very end: no trailing 0
    vals, offs = rle_encode_blocks(blocks)
    for b in range(blocks.shape[0]):
        assert vals[offs[b]:offs[b + 1]].tolist() == [int(v) for v in rle_encode_block(blocks[b])]


def test_control_transforms_differ_from_the_exact_ones():
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-40, 41, (500, 16, 16), generator=g, dtype=torch.int32)
    assert (dct2_float32(x) != dct2_int(x)).any()
    t = dct2_int(x)
    assert (idct2_float32(t) != idct2_int(t)).any()
    # and sit within rounding of them
    assert (dct2_float32(x) - dct2_int(x)).abs().max() <= 1
