"""The check fails what it must: the lower-precision control, and a run with the timed
path broken underneath (past the look for a card, on the CPU at a tiny size) comes out
with ``correct`` false, for each fault a cell can have.  The cells run on one card, so
no exchange between chips can be left out."""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import pytest
import torch

from portbench.control import control_numbers
from portbench.harness.correct import LIMITS
from portbench.harness.runner import run_cell
from portbench.reference.zigzag import rle_length
from streamoptima_tpu_torch import engine
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import kernels as K

#: every cell of BENCHMARK.json
BENCH = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def run(root, workload, capsys, seed=2**33 + 5) -> dict:
    args = argparse.Namespace(workload=workload, seed=seed, seconds=0.3, trace=0)
    assert run_cell(args, time.perf_counter(), root=root, device="cpu", require_card=False) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def stale_fifo(monkeypatch):
    """A step that returns its state unchanged: the reference FIFO keeps its first frame."""
    def push(refs, frame, nref):
        if not refs:
            refs.append(frame)
    monkeypatch.setattr(engine, "fifo_push", push)


def recount(split, qf, qq):
    """Each block's coded length, counted again from its coefficients as they now stand:
    an injection that alters them keeps the frame's sizes true to them, so that the
    container's write takes the frame and only the comparison can catch the fault."""
    return torch.where(split, rle_length(qq).sum(dim=1, dtype=torch.int32), rle_length(qf))


def half_the_blocks(monkeypatch):
    """Half of the batch left out: the second half of each frame's blocks codes (or decodes) nothing."""
    select, recon = K.transform_select, K.residual_recon

    def select_half(*a, **kw):
        split, qf, qq, lens, mae = select(*a, **kw)
        qf, qq = qf.clone(), qq.clone()
        qf[qf.shape[0] // 2:] = 0
        qq[qq.shape[0] // 2:] = 0
        return split, qf, qq, recount(split, qf, qq), mae

    def recon_half(qf, qq, *a, **kw):
        qf = qf.clone()
        qf[qf.shape[0] // 2:] = 0
        return recon(qf, qq, *a, **kw)

    monkeypatch.setattr(K, "transform_select", select_half)
    monkeypatch.setattr(K, "residual_recon", recon_half)


def altered_answer(monkeypatch):
    """An answer altered where it is produced: one coefficient of one frame's encode, one
    pixel of each decode."""
    select, finish = K.transform_select, VideoCodec._finish
    calls = [0]

    def select_altered(*a, **kw):
        split, qf, qq, lens, mae = select(*a, **kw)
        calls[0] += 1
        if calls[0] % 16 == 3:  # the DC coefficient of a block that is coded whole, or a quad's
            qf, qq = qf.clone(), qq.clone()
            whole = (~split).nonzero()
            if whole.numel():
                qf[int(whole[0, 0]), 0, 0] += 1
            else:
                qq[0, 0, 0, 0] += 1
            lens = recount(split, qf, qq)
        return split, qf, qq, lens, mae

    def finish_altered(self, frames):
        out = finish(self, frames)
        out[-1, 5, 9] ^= 1
        return out

    monkeypatch.setattr(K, "transform_select", select_altered)
    monkeypatch.setattr(VideoCodec, "_finish", finish_altered)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(tiny_root, workload, capsys):
    r = run(tiny_root, workload, capsys)
    assert r["correct"] and r["failed"] == 0
    assert r["compared"] and all(c["value"] == 0 == c["limit"] for c in r["compared"].values())


@pytest.mark.parametrize("fault", [stale_fifo, half_the_blocks, altered_answer])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, workload, fault, capsys, monkeypatch):
    fault(monkeypatch)
    r = run(tiny_root, workload, capsys)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["compared"].values())


@pytest.mark.parametrize("seed", [1, 2, 2**35 + 3])
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tiny_root, workload, seed):
    numbers = control_numbers(tiny_root, workload, seed, "cpu")
    assert numbers and any(v > LIMITS[k] for k, v in numbers.items())
