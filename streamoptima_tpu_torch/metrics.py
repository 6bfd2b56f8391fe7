"""Quality metrics on the device.

``psnr`` is the twin of ``streamoptima_tpu.metrics.psnr_jax`` (float32).
SSIM uses the JAX package's numpy ``metrics.ssim`` on the host.
"""
from __future__ import annotations

import torch


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Batched PSNR: a, b (..., h, w) -> (...,) float32."""
    err = ((a.to(torch.float32) - b.to(torch.float32)) ** 2).mean(dim=(-2, -1))
    return 10.0 * torch.log10((data_range ** 2) / err)
