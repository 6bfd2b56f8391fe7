"""Quality metrics: PSNR and SSIM on the device, SSIM on the host.

``psnr`` is the twin of ``streamoptima_tpu.metrics.psnr_jax`` (float32, on
the tensors' device).  ``ssim_torch`` and ``ssim_frames`` are the twins of
``ssim_jax`` and ``ssim_frames``: a clip's SSIM in one batched call on a
device.  ``ssim`` is the port's copy of the JAX package's numpy ``ssim``,
the float64 host reference the device version is held to.  All are
skimage-compatible SSIM (win_size 11, uniform filter, K1=0.01, K2=0.03,
data_range 255, covariance normalization N/(N-1)) without a skimage
dependency (Encoder.py:934-935).
"""
from __future__ import annotations

import numpy as np
import torch


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Batched PSNR: a, b (..., h, w) -> (...,) float32."""
    err = ((a.to(torch.float32) - b.to(torch.float32)) ** 2).mean(dim=(-2, -1))
    return 10.0 * torch.log10((data_range ** 2) / err)


def ssim(a, b, win_size: int = 11, data_range: float = 255.0) -> float:
    """Host SSIM of two frames (uniform filter in 'reflect' boundary mode)."""
    from scipy.ndimage import uniform_filter

    im1 = np.asarray(a, dtype=np.float64)
    im2 = np.asarray(b, dtype=np.float64)
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    npix = win_size ** 2
    cov_norm = npix / (npix - 1)
    ux = uniform_filter(im1, win_size)
    uy = uniform_filter(im2, win_size)
    uxx = uniform_filter(im1 * im1, win_size)
    uyy = uniform_filter(im2 * im2, win_size)
    uxy = uniform_filter(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def _window_sums(v: torch.Tensor, win_size: int) -> torch.Tensor:
    """Sums of every whole ``win_size`` x ``win_size`` window of (..., h, w)
    int32 ``v``: (..., h - win_size + 1, w - win_size + 1), by shifted adds
    in int32, exact.  No convolution: cuDNN may run one in TF32, which
    truncates the sums on the card but not on the CPU."""
    h, w = v.shape[-2] - win_size + 1, v.shape[-1] - win_size + 1
    rows = sum(v[..., i:i + h, :] for i in range(win_size))
    return sum(rows[..., :, j:j + w] for j in range(win_size))


def ssim_torch(a: torch.Tensor, b: torch.Tensor, win_size: int = 11, data_range: float = 255.0) -> torch.Tensor:
    """Batched SSIM on the tensors' device: a, b (..., h, w) uint8 -> (...,)
    float32, the twin of ``streamoptima_tpu.metrics.ssim_jax``.

    The window sums of the -128-shifted pixels, their squares and products
    are integer-exact in int32 (|sum| <= 121 * 128^2 < 2^31).  They are
    taken over whole windows only: the result keeps only the pixels at least
    ``win_size // 2`` from every edge, whose windows never reach the reflect
    padding, so no padding is needed.  From the sums on, the float32
    arithmetic is ``ssim_jax``'s, in its order.  The mean over each frame
    accumulates in float64: the reduction's order differs between devices,
    and a float32 sum of a 720p frame's 900k terms could drift past 1e-6."""
    x = a.to(torch.int32) - 128
    y = b.to(torch.int32) - 128
    npix = win_size ** 2
    # a divisor on the device: CUDA divides by a host scalar as a product
    # with its reciprocal, which rounds differently from a division
    npix_t = torch.tensor(float(npix), device=x.device)

    def mean_of(v):
        return _window_sums(v, win_size).to(torch.float32) / npix_t

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    cov_norm = npix / (npix - 1)
    ux, uy = mean_of(x), mean_of(y)
    uxx, uyy, uxy = mean_of(x * x), mean_of(y * y), mean_of(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    uxr = ux + 128.0  # luminance uses raw means (the shift is variance-only)
    uyr = uy + 128.0
    s = ((2 * uxr * uyr + c1) * (2 * vxy + c2)) / ((uxr * uxr + uyr * uyr + c1) * (vx + vy + c2))
    return s.to(torch.float64).mean(dim=(-2, -1)).to(torch.float32)


def ssim_frames(y_frames, recon_frames, win_size: int = 11, *, device="cuda") -> list[float]:
    """Per-frame SSIM of a clip, (n, h, w) uint8 arrays or tensors, in one
    batched call on ``device`` (``ssim_frames`` of the JAX package)."""
    a, b = (f if isinstance(f, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(f))
            for f in (y_frames, recon_frames))
    return ssim_torch(a.to(device), b.to(device), win_size).cpu().tolist()
