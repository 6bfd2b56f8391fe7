"""Run-length code lengths over the diagonal scan (RD cost and frame size).

Twin of ``streamoptima_tpu.core.zigzag.rle_length``: the entropy-coded list
length of a block is ``nnz + #nonzero-runs + #zero-runs`` over its diagonal
scan (a trailing zero run emits one ``0``; an all-zero block encodes as
``[0]``).  The host serializer itself is reused from the JAX package.
"""
from __future__ import annotations

import functools

import torch

from streamoptima_tpu.core.zigzag import diag_scan_indices


@functools.lru_cache(maxsize=None)
def scan_indices(n: int, device: torch.device) -> torch.Tensor:
    """Flat diagonal-scan indices as int64 on ``device`` (cached)."""
    return torch.from_numpy(diag_scan_indices(n)).to(device=device, dtype=torch.int64)


def rle_length(blocks: torch.Tensor) -> torch.Tensor:
    """Encoded-list length of each block ``(..., n, n)`` -> ``(...)`` int32."""
    n = blocks.shape[-1]
    seq = blocks.reshape(blocks.shape[:-2] + (n * n,))[..., scan_indices(n, blocks.device)]
    z = seq == 0
    nnz = (~z).sum(dim=-1)
    starts = z[..., 1:] != z[..., :-1]
    nz_runs = (~z[..., :1]).sum(dim=-1) + (starts & ~z[..., 1:]).sum(dim=-1)
    z_runs = z[..., :1].sum(dim=-1) + (starts & z[..., 1:]).sum(dim=-1)
    return (nnz + nz_runs + z_runs).to(torch.int32)
