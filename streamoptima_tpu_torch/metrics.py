"""Quality metrics: PSNR on the device, SSIM on the host.

``psnr`` is the twin of ``streamoptima_tpu.metrics.psnr_jax`` (float32, on
the tensors' device).  ``ssim`` is the port's copy of the JAX package's
numpy ``ssim``: skimage-compatible SSIM
(win_size 11, uniform filter, K1=0.01, K2=0.03, data_range 255, covariance
normalization N/(N-1)) without a skimage dependency (Encoder.py:934-935).
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
