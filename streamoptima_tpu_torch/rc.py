"""Rate control: per-row QP selection, scene-change promotion, two-pass.

The port's own copy of ``streamoptima_tpu.rc``: the host functions are the
same numpy code, and ``measure_qp_tables`` measures with ``TorchCodec``'s
steps where the original runs ``JaxCodec``'s (the row bits are bit-identical,
so the tables are too).

The reference's per-row budget recursion (Encoder.py:1597-1609, :1665-1678)
carries over ``budget - table_bitrate(QP)`` - the *table* value, not actual
bits - so the whole per-row QP sequence is a pure function of
(bitrate_per_row, table) and is identical for every frame.  Quirk K9: both
intra and inter flows index table 0 (the intra table; Encoder.py:1671); the
native engine, which this package ports, indexes the table of the frame's
type.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def pick_qp(table, budget: float):
    """First (qp, bitrate) with bitrate < budget (get_appropriate_Qp_value,
    Encoder.py:1576-1580).  Raises like-for-like instead of returning None."""
    for qp, bitrate in enumerate(table):
        if bitrate < budget:
            return qp, bitrate
    raise ValueError(
        "no QP in the rate table fits the row budget "
        f"({budget}); the reference crashes here (bug B6)"
    )


def row_qp_sequence(cfg, frame_type: int = 0):
    """Per-row QPs for one frame; identical across frames (quirk K10).

    frame_type is forced to 0 in compat mode (quirk K9); the native engine
    uses the per-type table and clamps to the largest QP when no table entry
    fits the budget instead of crashing (bug B6).
    """
    table_idx = 0 if cfg.compat else frame_type
    table = cfg.qp_rate_tables[table_idx]
    per_row = cfg.bitrate_per_row
    qps = []
    budget = per_row
    for r in range(cfg.block_rows):
        if r > 0:
            budget = per_row + (budget - bits)
        try:
            qp, bits = pick_qp(table, budget)
        except ValueError:
            if cfg.compat:
                raise
            qp = len(table) - 1
            bits = table[qp]
        qps.append(qp)
    return qps


def measure_qp_tables(cfg, y_frames, sample_frames: int = 2, *, device="cuda"):
    """Measure per-row bitrate tables by encoding sample frames at every QP.

    table[frame_type][qp] = mean entropy-coded bits per block row (8 bits per
    RLE symbol) over ``sample_frames`` frames coded intra (type 0) or inter
    (type 1, against the previous source frame) at that QP, by
    ``TorchCodec``'s steps on ``device``.  Returns [intra_table,
    inter_table], each 12 entries (QP 0..11).
    """
    from streamoptima_tpu_torch.engine import TorchCodec

    y = np.asarray(y_frames)[: sample_frames + 1]
    tables = []
    for ftype in (0, 1):
        row = []
        for qp in range(12):
            c = dataclasses.replace(cfg, qp=qp, frames=len(y), rc_flag=None, target_br=None, qp_rate_tables=None,
                                    two_pass=False, engine="jax")
            codec = TorchCodec(c, y, device=device)
            bits = []
            for i in range(1, len(y)):
                cur = codec._y_dev[i]
                if ftype == 0:
                    out = codec._intra_step(cur)
                else:
                    out = codec._inter_step(cur, codec.motion.planes([codec._y_dev[i - 1]]))
                bits.append(8.0 * float(out["row_bits"].to(torch.float32).mean()))
            row.append(float(np.mean(bits)))
        tables.append(row)
    return tables


def row_wise_stats(bits_cum_per_row):
    """First-pass statistics: per-row share (%) of the frame's bits
    (Encoder.py:1627-1639; computed then discarded by the reference)."""
    total = bits_cum_per_row[-1]
    diffs = np.diff(np.concatenate([[0], np.asarray(bits_cum_per_row, dtype=np.float64)]))
    return (diffs / total) * 100.0 if total else diffs * 0.0


def two_pass_row_budgets(cfg, stats_pct):
    """Second pass: reallocate the frame budget by first-pass row shares."""
    frame_budget = (cfg.target_bitrate // cfg.frame_rate) if cfg.target_bitrate else 0
    shares = np.asarray(stats_pct, dtype=np.float64) / 100.0
    return frame_budget * shares


def second_pass_row_qps(cfg, row_bits, frame_type: int, fallback):
    """Second-pass per-row QPs from first-pass row bits (host math).
    ``fallback`` is returned when the frame spent no bits."""
    row_bits = np.asarray(row_bits, dtype=np.float64)
    total = row_bits.sum()
    if total <= 0:
        return np.asarray(fallback, dtype=np.int32)
    stats_pct = row_bits / total * 100.0
    budgets = two_pass_row_budgets(cfg, stats_pct)
    return np.asarray(row_qp_from_budgets(cfg, budgets, frame_type), dtype=np.int32)


def row_qp_from_budgets(cfg, budgets, frame_type: int = 0):
    """Pick a QP per row from explicit per-row budgets (two-pass second pass);
    a budget no entry fits takes the largest QP (bug B6 clamped)."""
    table_idx = 0 if cfg.compat else frame_type
    table = cfg.qp_rate_tables[table_idx]
    out = []
    for b in budgets:
        try:
            qp, _ = pick_qp(table, b)
        except ValueError:
            qp = len(table) - 1
        out.append(qp)
    return out
