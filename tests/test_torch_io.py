"""PyTorch port: the colour pipeline of ``io.video.VideoManager`` against the
JAX package's, on the same seeded bytes, from a path and from an array.

Every output must be equal: the 4:2:0 and 4:4:4 frames, the upsampled
chroma, the RGB conversion (float32 pixels against the float64 matrix, at
every clip edge: pixels 0, 15, 16, 235, 240 and 255 in each plane) and the
Y planes; and both refuse the same misuse with ``ValueError``.
"""
import numpy as np
import pytest

from streamoptima_tpu.io.video import VideoManager as JVM
from streamoptima_tpu_torch.io.video import VideoManager as TVM

H, W, N = 32, 48, 3
EDGES = np.array([0, 15, 16, 235, 240, 255], np.uint8)


def _raw(v_type: str) -> np.ndarray:
    """Random bytes of an N-frame clip, with the clip edges at the head of
    every plane of every frame."""
    rng = np.random.default_rng(11 if v_type == "yuv_420" else 12)
    ny = H * W
    planes = (ny, ny // 4, ny // 4) if v_type == "yuv_420" else (ny, ny, ny)
    frames = []
    for _ in range(N):
        for size in planes:
            p = rng.integers(0, 256, size, dtype=np.uint8)
            p[:len(EDGES)] = EDGES
            p[len(EDGES):2 * len(EDGES)] = EDGES[::-1]
            frames.append(p)
    return np.concatenate(frames)


def _managers(v_type: str, source: str, tmp_path):
    raw = _raw(v_type)
    if source == "path":
        f = tmp_path / "clip.yuv"
        raw.tofile(f)
        return JVM(f, H, W, N, v_type), TVM(f, H, W, N, v_type)
    return JVM(raw, H, W, N, v_type), TVM(raw, H, W, N, v_type)


@pytest.mark.parametrize("source", ["path", "array"])
def test_yuv420_pipeline_matches_jax_package(source, tmp_path):
    jm, tm = _managers("yuv_420", source, tmp_path)
    np.testing.assert_array_equal(tm.vid_frames_yuv420, jm.vid_frames_yuv420)
    np.testing.assert_array_equal(tm.upscale_yuv420_to_yuv444(), jm.upscale_yuv420_to_yuv444())
    np.testing.assert_array_equal(tm.vid_frames_yuv444, jm.vid_frames_yuv444)
    rgb = tm.convert_yuv444_to_rgb()
    np.testing.assert_array_equal(rgb, jm.convert_yuv444_to_rgb())
    assert rgb.dtype == np.uint8 and rgb.shape == (N, H, W, 3)
    assert rgb.min() == 0 and rgb.max() == 255  # the clip reaches both ends
    np.testing.assert_array_equal(tm.vid_frames_rgb, jm.vid_frames_rgb)
    np.testing.assert_array_equal(tm.extract_y_only(), jm.extract_y_only())


@pytest.mark.parametrize("source", ["path", "array"])
def test_yuv444_pipeline_matches_jax_package(source, tmp_path):
    jm, tm = _managers("yuv_444", source, tmp_path)
    np.testing.assert_array_equal(tm.vid_frames_yuv444, jm.vid_frames_yuv444)
    np.testing.assert_array_equal(tm.convert_yuv444_to_rgb(), jm.convert_yuv444_to_rgb())
    np.testing.assert_array_equal(tm.extract_y_only(), jm.extract_y_only())
    with pytest.raises(ValueError, match="4:2:0"):
        tm.upscale_yuv420_to_yuv444()
    with pytest.raises(ValueError, match="4:2:0"):
        jm.upscale_yuv420_to_yuv444()


def test_rgb_conversion_rounds_like_the_float64_matrix():
    """Every (Y, U, V) triple of clip-edge and near-edge values gives the JAX
    package's RGB; an all-float32 product would differ on some."""
    vals = np.array([0, 1, 15, 16, 17, 127, 128, 129, 234, 235, 236, 239, 240, 241, 254, 255], np.uint8)
    y, u, v = np.meshgrid(vals, vals, vals, indexing="ij")
    yuv = np.stack([y.reshape(1, -1), u.reshape(1, -1), v.reshape(1, -1)], axis=1)  # (1, 3, 1, 4096)
    raw = yuv.reshape(-1)
    tm, jm = TVM(raw, 1, vals.size ** 3, 1, "yuv_444"), JVM(raw, 1, vals.size ** 3, 1, "yuv_444")
    np.testing.assert_array_equal(tm.convert_yuv444_to_rgb(), jm.convert_yuv444_to_rgb())


@pytest.mark.parametrize("Manager", [JVM, TVM], ids=["jax", "port"])
def test_both_refuse_misuse(Manager):
    with pytest.raises(ValueError, match="cannot parse"):
        Manager(np.zeros(16, np.uint8), 2, 2, 1, "rgb")
    m = Manager(np.zeros(6, np.uint8), 2, 2, 1, "yuv_420")
    with pytest.raises(ValueError, match="4:4:4"):
        m.convert_yuv444_to_rgb()
    with pytest.raises(ValueError, match="4:4:4"):
        m.extract_y_only()
