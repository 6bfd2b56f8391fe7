"""Diagonal scan order and run-length coding.

The port's copy of ``streamoptima_tpu.core.zigzag``.  The reference entropy
codes each quantized block by walking anti-diagonals top-right to
bottom-left (``k``-loop in Encoder.py:1086-1131) emitting ``-n`` = run of n
nonzeros followed by the n values, ``+n`` = run of n zeros, and a single
trailing ``0`` once the rest of the block is zero.

On the device only the coded *length* is needed (RD cost and frame size):
``rle_length`` is ``nnz + #nonzero-runs + #zero-runs`` over the diagonal
scan (a trailing zero run emits one ``0``; an all-zero block encodes as
``[0]``).  The host lists themselves come from ``rle_encode_block`` /
``rle_decode_block`` (numpy), bit-exact with the reference; the native
serializer (``streamoptima_tpu_torch.native``) produces the same bytes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def diag_scan_indices(n: int) -> np.ndarray:
    """Flat indices of the (i,j) visit order of the reference's diagonal scan."""
    order = []
    for k in range(2 * n - 1):
        i, j = (0, k) if k < n else (k - n + 1, n - 1)
        while i < n and j >= 0:
            order.append(i * n + j)
            i += 1
            j -= 1
    return np.asarray(order, dtype=np.int32)


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


def rle_encode_block(block: np.ndarray, numpy_repr: bool = False) -> list:
    """Bit-exact twin of entropy_encoder_block (Encoder.py:1086-1131).

    Returns the mixed int / np.int64 list the reference builds: run headers
    and zero counts are Python ints; coefficient values keep their numpy
    scalar type when ``numpy_repr`` (the reference's file text under
    numpy>=2, where values print as ``np.int64(v)``).
    """
    n = block.shape[-1]
    seq = np.asarray(block).reshape(n * n)[diag_scan_indices(n)]
    result: list = []
    run_vals: list = []
    zero_count = 0
    for v in seq:
        if v != 0:
            if run_vals == [] and zero_count:
                result.append(int(zero_count))
                zero_count = 0
            run_vals.append(np.int64(v) if numpy_repr else int(v))
        else:
            if run_vals:
                result.append(-len(run_vals))
                result.extend(run_vals)
                run_vals = []
            zero_count += 1
    if run_vals:
        result.append(-len(run_vals))
        result.extend(run_vals)
    if zero_count:
        result.append(0)
    return result


def rle_decode_block(encoded: list, n: int) -> np.ndarray:
    """Twin of entropy_decoder_block (decoder.py:548-586): list -> (n, n) int."""
    vals: list = []
    i = 0
    while i < len(encoded):
        c = encoded[i]
        if c < 0:
            vals.extend(encoded[i + 1 : i + 1 - c])
            i += -c
        else:
            if c == 0:
                break
            vals.extend([0] * c)
        i += 1
    out = np.zeros(n * n, dtype=np.int64)
    idx = diag_scan_indices(n)
    m = min(len(vals), n * n)
    out[idx[:m]] = vals[:m]
    return out.reshape(n, n)
