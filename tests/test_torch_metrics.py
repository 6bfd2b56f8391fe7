"""PyTorch port: SSIM on the device (``metrics.ssim_frames``, here on the CPU)
against the JAX package's ``ssim_frames`` and the float64 host ``ssim``.

Within 1e-6 of both on ``test_jax_engine.py``'s inputs (``synthetic_clip``
and ``smooth_clip`` against themselves plus noise in [-5, 5)), an all-equal
pair (SSIM 1), the extremes 0 and 255, and 16 x 16 frames, the smallest a
16-pixel block codes (the crop leaves 6 x 6 pixels).  The window sums
are exact integers; the facade's "SSIM per frame" is ``ssim_frames``, on
one device and on a mesh.
"""
import numpy as np
import pytest
import torch

from conftest import smooth_clip, synthetic_clip

from streamoptima_tpu import metrics as JM
from streamoptima_tpu_torch import CodecConfig
from streamoptima_tpu_torch import metrics as TM
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.parallel import make_mesh


def _noisy(clip: np.ndarray, seed: int = 5) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    b = np.clip(clip.astype(np.int32) + rng.integers(-5, 5, clip.shape), 0, 255).astype(np.uint8)
    return clip, b


def _pairs():
    flat = np.full((2, 24, 40), 77, np.uint8)
    rng = np.random.default_rng(9)
    return {
        "synthetic": _noisy(synthetic_clip(64, 96, 2)),
        "smooth": _noisy(smooth_clip(64, 96, 2)),
        "equal": (smooth_clip(48, 64, 2),) * 2,
        "flat": (flat, flat.copy()),
        "extremes": (np.zeros((1, 32, 32), np.uint8), np.full((1, 32, 32), 255, np.uint8)),
        "black_vs_noise": (np.zeros((1, 32, 32), np.uint8), rng.integers(0, 256, (1, 32, 32), dtype=np.uint8)),
        "16x16": _noisy(smooth_clip(16, 16, 3)),
    }


@pytest.mark.parametrize("name", list(_pairs()))
def test_ssim_frames_matches_jax_and_host(name):
    a, b = _pairs()[name]
    got = TM.ssim_frames(a, b, device="cpu")
    assert len(got) == len(a) and all(isinstance(v, float) for v in got)
    jax = JM.ssim_frames(a, b)
    host = [TM.ssim(x, y) for x, y in zip(a, b)]
    np.testing.assert_allclose(got, jax, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-6)
    if name in ("equal", "flat"):
        assert got == [1.0] * len(a)
    # tensors in, as arrays
    assert TM.ssim_frames(torch.from_numpy(a), torch.from_numpy(b), device="cpu") == got


def test_window_sums_are_exact_integers():
    """The int32 window sums equal numpy's int64 sums at the extremes
    (121 * 128^2 for an all-black frame's squares)."""
    rng = np.random.default_rng(3)
    for v in (rng.integers(-128, 128, (2, 20, 33)), np.full((1, 11, 11), -128), np.full((1, 12, 13), 127)):
        t = torch.from_numpy(v.astype(np.int32))
        for x in (t, t * t):
            want = np.lib.stride_tricks.sliding_window_view(x.numpy().astype(np.int64), (11, 11), axis=(-2, -1))
            np.testing.assert_array_equal(TM._window_sums(x, 11).numpy(), want.sum(axis=(-2, -1)))


@pytest.mark.parametrize("where", ["device", "mesh"])
def test_facade_ssim_is_ssim_frames(where):
    clip = smooth_clip(64, 64, 4)
    cfg = CodecConfig(height=64, width=64, frames=4, search_range=4, qp=6, intra_dur=2)
    place = {"device": "cpu"} if where == "device" else {"mesh": make_mesh(cfg, devices=["cpu"] * 2)}
    pkg = VideoCodec(cfg, clip, **place).encode()
    assert pkg["SSIM per frame"] == TM.ssim_frames(clip, pkg["reconstructed frames"], device="cpu")
    assert pkg["timing"]["ssim_s"] > 0
    np.testing.assert_allclose(pkg["SSIM per frame"], [TM.ssim(a, b) for a, b in zip(clip, pkg["reconstructed frames"])],
                               rtol=0, atol=1e-6)
