"""Rate control: the target bitrate, per-row QPs and the second pass's row QPs.

Plain host arithmetic after the upstream encoder's rule (Suyashagarw/StreamOptima
``Encoder.py``), as the native engine states it:

- each block row takes the first QP of the rate table whose bits fit the
  row's budget, and a row carries its budget's rest on to the next
  (``get_appropriate_Qp_value`` and the budget recursion);
- the table is that of the frame's own type (upstream reads the intra table
  for inter frames too: quirk K9, which the native engine does not keep);
- a budget that no entry fits takes the largest QP (upstream crashes there:
  bug B6);
- the carry is the table's bits, not the bits spent, so a frame type's row
  QPs are one sequence for every frame.

Two-pass has no upstream rule (``Encoder.py:1627-1639`` computes each row's
share of the first pass's bits and drops it).  The native engine's second
pass gives each row that share of the frame's budget, target bits a second
over frames a second, and picks its QP from the frame type's table alone,
with no carry; a frame that spent no bits keeps the table rows.  The float
operations are the engine's, in its order: every pick is a comparison
``bits < budget``, which a rounding of its own could flip.
"""
from __future__ import annotations

import numpy as np


def parse_bitrate(target_br) -> int | None:
    """'<n> bps|kbps|mbps' -> bits a second, 1024-based (Encoder.py:78-88);
    an int passes through."""
    if target_br is None:
        return None
    if isinstance(target_br, (int, float)):
        return int(target_br)
    num, unit = target_br.split(" ")[:2]
    return int(num) * {"kbps": 1024, "mbps": 1048576}.get(unit, 1)


def bitrate_per_row(target_br, frame_rate: int, height: int, bs: int) -> float:
    """A block row's budget: (bits a second // frames a second) / block rows
    (Encoder.py:88)."""
    return (parse_bitrate(target_br) // frame_rate) / (height / bs)


def pick_qp(table, budget: float) -> int:
    """The first QP whose table bits are below ``budget``
    (get_appropriate_Qp_value, Encoder.py:1576-1580); the largest where none
    is (bug B6, clamped)."""
    for qp, bits in enumerate(table):
        if bits < budget:
            return qp
    return len(table) - 1


def row_qps(table, per_row: float, rows: int) -> list[int]:
    """A frame's per-row QPs: row r's budget is ``per_row`` plus what row
    r - 1 left of its own, counted at the table's bits (Encoder.py:1597-1609
    intra, :1665-1678 inter)."""
    out, budget = [], per_row
    for r in range(rows):
        if r > 0:
            budget = per_row + (budget - table[out[-1]])
        out.append(pick_qp(table, budget))
    return out


def second_pass_row_qps(row_bits, table, frame_budget: int, fallback) -> list[int]:
    """Pass 2's row QPs of one frame from pass 1's bits of each row: every
    row's share of the frame's bits, as a percentage and back, times
    ``frame_budget``, picked from ``table`` (the native engine's
    ``rc.second_pass_row_qps``); ``fallback`` where the frame spent none."""
    row_bits = np.asarray(row_bits, dtype=np.float64)
    total = row_bits.sum()
    if total <= 0:
        return [int(q) for q in fallback]
    budgets = frame_budget * ((row_bits / total * 100.0) / 100.0)
    return [pick_qp(table, b) for b in budgets]
