"""PyTorch port on a CUDA card: each hand-written kernel against its plain
PyTorch version on the same device tensors, exactly.

These need a card and skip without one; the card's machine runs them with
``python -m pytest tests/test_torch_gpu.py -q``.  This file imports no JAX
(the card's machine has none); the parity of the plain versions with the JAX
package is the CPU tests' job.
"""
import numpy as np
import pytest
import torch

from streamoptima_tpu_torch import CodecConfig, synthetic_clip
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import me as M
from streamoptima_tpu_torch.core import transform as T
from streamoptima_tpu_torch.engine import TorchCodec

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _search_equal(a, b):
    for k in ("mv", "sad", "ok", "pred"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("h,w,sr,nref", [(48, 64, 4, 1), (64, 96, 8, 2), (96, 128, 16, 3), (64, 64, 40, 1)])
def test_full_search_kernel_matches_plain(cuda, h, w, sr, nref):
    rng = np.random.default_rng(h * sr + nref)
    cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
    refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    n0 = K.full_search.launches
    got = K.full_search(cur, refs, sr, 16)
    torch.cuda.synchronize()
    assert K.full_search.launches == n0 + 1
    _search_equal(got, K.full_search_plain(cur, refs, sr, 16))


@pytest.mark.parametrize("case", ["flat", "black_vs_white", "one_column"])
def test_full_search_kernel_ties_and_no_candidate(cuda, case):
    h, w = (48, 16) if case == "one_column" else (48, 64)
    fill = {"flat": (90, 90), "black_vs_white": (0, 255), "one_column": (3, 5)}[case]
    cur = torch.full((h, w), fill[0], dtype=torch.uint8, device=cuda)
    refs = torch.full((2, h, w), fill[1], dtype=torch.uint8, device=cuda)
    got = K.full_search(cur, refs, 4, 16)
    _search_equal(got, K.full_search_plain(cur, refs, 4, 16))


def test_pred_fetch_kernel_matches_plain(cuda):
    rng = np.random.default_rng(5)
    h, w, nref = 64, 96, 2
    nb = (h // 16) * (w // 16)
    refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    mv = np.stack([rng.integers(-70, 71, nb), rng.integers(-50, 51, nb), rng.integers(0, nref, nb)], 1)
    mv = torch.from_numpy(mv.astype(np.int32)).to(cuda)
    n0 = K.pred_fetch.launches
    got = K.pred_fetch(mv, refs, 16)
    torch.cuda.synchronize()
    assert K.pred_fetch.launches == n0 + 1
    assert torch.equal(got, K.pred_fetch_plain(mv, refs, 16))


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    cur = torch.zeros((48, 64), dtype=torch.int32, device=cuda)
    refs = torch.zeros((1, 48, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        K.full_search(cur, refs, 4, 16)
    with pytest.raises(ValueError):
        K.pred_fetch(torch.zeros((12, 3), dtype=torch.int64, device=cuda), refs, 16)


def test_int_dct_on_card_matches_cpu_at_extremes(cuda):
    rng = np.random.default_rng(6)
    x = rng.integers(-255, 256, (64, 16, 16)).astype(np.int32)
    x[0], x[1] = 255, -255
    t = rng.integers(-12288, 12289, (64, 16, 16)).astype(np.int32)
    t[0], t[1] = 12288, -12288
    for f, a in ((T.dct2_int, x), (T.idct2_int, t)):
        ref = f(torch.from_numpy(a))
        assert torch.equal(f(torch.from_numpy(a).to(cuda)).cpu(), ref)


def test_engine_on_card_matches_cpu(cuda):
    cfg = CodecConfig(height=64, width=96, frames=5, search_range=8, qp=4, intra_dur=4)
    clip = synthetic_clip(64, 96, 5)
    a = TorchCodec(cfg, clip, device=cuda).encode(package=False)
    b = TorchCodec(cfg, clip, device="cpu").encode(package=False)
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    for fa, fb in zip(a["per_frame"], b["per_frame"]):
        for k in ("mv", "qtc_full", "size"):
            assert torch.equal(fa[k].cpu(), fb[k]), k


# ------------------------------------------------------- VBS + FME modes
def _planes_on(cuda, rng, h, w, nref, wrap=True):
    refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    return M.fme_parity_planes(refs, wrap)


def _fme_search_equal(a, b):
    for k in ("mv", "sad", "ok", "sub_mv", "sub_sad", "sub_ok"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("h,w,sr,nref,wrap", [(48, 64, 4, 1, True), (64, 96, 8, 2, False), (96, 128, 8, 1, True),
                                              (64, 64, 20, 3, True)])
def test_fme_vbs_search_kernel_matches_plain(cuda, h, w, sr, nref, wrap):
    rng = np.random.default_rng(h * sr + nref)
    cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
    planes = _planes_on(cuda, rng, h, w, nref, wrap)
    n0 = K.full_search_fme_vbs.launches
    got = K.full_search_fme_vbs(cur, planes, sr, 16)
    torch.cuda.synchronize()
    assert K.full_search_fme_vbs.launches == n0 + 1
    _fme_search_equal(got, K.full_search_fme_vbs_plain(cur, planes, sr, 16))


@pytest.mark.parametrize("case", ["flat", "black_vs_white", "two_refs_tie"])
def test_fme_vbs_search_kernel_ties_and_no_candidate(cuda, case):
    h, w = 48, 64
    fill = {"flat": (90, (90, 90)), "black_vs_white": (0, (255, 255)), "two_refs_tie": (10, (12, 8))}[case]
    cur = torch.full((h, w), fill[0], dtype=torch.uint8, device=cuda)
    refs = torch.stack([torch.full((h, w), v, dtype=torch.uint8, device=cuda) for v in fill[1]])
    planes = M.fme_parity_planes(refs, True)
    got = K.full_search_fme_vbs(cur, planes, 4, 16)
    _fme_search_equal(got, K.full_search_fme_vbs_plain(cur, planes, 4, 16))
    assert not bool(got["ok"].all())


@pytest.mark.parametrize("bound", [16, 60, 5000])
def test_fme_quad_fetch_kernel_matches_plain(cuda, bound):
    """Cases A, B and C per block and per quad, MVs far past 2sr too."""
    rng = np.random.default_rng(bound)
    h, w, nref = 64, 96, 2
    nb = (h // 16) * (w // 16)
    planes = _planes_on(cuda, rng, h, w, nref)
    mv = np.stack([rng.integers(-bound, bound + 1, nb), rng.integers(-bound, bound + 1, nb),
                   rng.integers(0, nref, nb)], 1).astype(np.int32)
    smv = np.stack([rng.integers(-bound, bound + 1, (nb, 4)), rng.integers(-bound, bound + 1, (nb, 4)),
                    rng.integers(0, nref, (nb, 4))], 2).astype(np.int32)
    mv, smv = torch.from_numpy(mv).to(cuda), torch.from_numpy(smv).to(cuda)
    n0 = K.pred_fetch_fme_vbs.launches
    got = K.pred_fetch_fme_vbs(mv, smv, planes, 16)
    torch.cuda.synchronize()
    assert K.pred_fetch_fme_vbs.launches == n0 + 1
    plain = K.pred_fetch_fme_vbs_plain(mv, smv, planes, 16)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def test_engine_vbs_fme_on_card_matches_cpu(cuda):
    cfg = CodecConfig(height=64, width=96, frames=5, search_range=8, qp=4, intra_dur=4, vbs_enable=True,
                      fme_enable=True)
    clip = synthetic_clip(64, 96, 5)
    a = TorchCodec(cfg, clip, device=cuda).encode(package=False)
    b = TorchCodec(cfg, clip, device="cpu").encode(package=False)
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    for fa, fb in zip(a["per_frame"], b["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size"):
            assert torch.equal(fa[k].cpu(), fb[k]), k


# ------------------------------------------------------- fast-ME kernels
@pytest.mark.parametrize("nwin,nwin_c", [(18, None), (10, None), (21, 69), (3, 40)])
def test_window_fetch_kernel_matches_plain(cuda, nwin, nwin_c):
    """Origins inside, straddling every edge, far outside and odd."""
    rng = np.random.default_rng(nwin)
    P, H, W = 8, 64, 96
    planes = torch.from_numpy(rng.integers(1, 256, (P, H, W), dtype=np.uint8)).to(cuda)
    nb = 200
    by0 = rng.integers(-40, H + 40, nb).astype(np.int32)
    bx0 = rng.integers(-90, W + 90, nb).astype(np.int32)
    by0[:6] = (-5, H - 3, 7, 9, -(10**6), 2**30)
    bx0[:6] = (11, 13, -7, W - 5, 10**6, -(2**30))
    by0, bx0 = torch.from_numpy(by0).to(cuda), torch.from_numpy(bx0).to(cuda)
    n0 = K.window_fetch.launches
    got = K.window_fetch(planes, by0, bx0, nwin, nwin_c)
    torch.cuda.synchronize()
    assert K.window_fetch.launches == n0 + 1
    assert got.dtype == torch.uint8 and got.shape == (nb, P, nwin, nwin_c or nwin)
    assert torch.equal(got, K.window_fetch_plain(planes, by0, bx0, nwin, nwin_c))


def _chain_inputs(cuda, rng, h, w, nref, fme, case):
    fill = {"flat": (77, 77), "black_vs_white": (0, 255)}.get(case)
    if fill is None:
        cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
        refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    else:
        cur = torch.full((h, w), fill[0], dtype=torch.uint8, device=cuda)
        refs = torch.full((nref, h, w), fill[1], dtype=torch.uint8, device=cuda)
    return cur, M.fme_parity_planes(refs, True) if fme else refs


@pytest.mark.parametrize("fme", [False, True])
@pytest.mark.parametrize("case", ["random", "flat", "black_vs_white"])
@pytest.mark.parametrize("h,w,nref", [(64, 96, 1), (96, 256, 2), (720, 1280, 1)])
def test_rowscan_pass_kernel_matches_plain(cuda, h, w, nref, case, fme):
    """Zero seeds and wild seeds (negative odd MVs, K8 fallbacks far outside
    the frame, a second reference index), up to the 720p shape."""
    rng = np.random.default_rng(h + nref + fme)
    cur, planes = _chain_inputs(cuda, rng, h, w, nref, fme, case)
    S = h // 16
    wild = rng.integers(-9, 10, (S, 3)).astype(np.int32)
    wild[:, 2] = rng.integers(0, nref, S)
    wild[0] = (-3, -5, 0)
    wild[1] = (5001, -4001, nref - 1)
    wild[2] = (-2 * w - 1, 2 * h + 1, 0)
    for seeds in (torch.zeros((S, 3), dtype=torch.int32, device=cuda), torch.from_numpy(wild).to(cuda)):
        n0 = K.rowscan_pass.launches
        got = K.rowscan_pass(cur, planes, seeds, 16, fme)
        torch.cuda.synchronize()
        assert K.rowscan_pass.launches == n0 + 1
        assert got.dtype == torch.int32 and got.shape == (S, w // 16, 3)
        assert torch.equal(got, K.rowscan_pass_plain(cur, planes, seeds, 16, fme))


def test_fast_me_wrappers_raise_instead_of_falling_back(cuda):
    cur = torch.zeros((48, 64), dtype=torch.uint8, device=cuda)
    refs = torch.zeros((1, 48, 64), dtype=torch.uint8, device=cuda)
    seeds = torch.zeros((3, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="planes"):
        K.rowscan_pass(cur, refs, seeds, 16, True)
    with pytest.raises(ValueError, match="seeds"):
        K.rowscan_pass(cur, refs, seeds.to(torch.int64), 16, False)
    with pytest.raises(ValueError, match="by0"):
        K.window_fetch(refs, seeds[:, 0].to(torch.int64), seeds[:, 1].contiguous(), 18)
    with pytest.raises(TypeError):
        K.window_fetch(refs.to(torch.int16), seeds[:, 0].contiguous(), seeds[:, 1].contiguous(), 18)


@pytest.mark.parametrize("extra", [{}, {"vbs_enable": True, "fme_enable": True}], ids=["whole_pel", "vbs_fme"])
def test_engine_fast_me_on_card_matches_cpu(cuda, extra):
    cfg = CodecConfig(height=64, width=96, frames=6, search_range=16, qp=4, intra_dur=4, lam=0.015, fast_me=True,
                      **extra)
    clip = synthetic_clip(64, 96, 6, seed=3)
    a = TorchCodec(cfg, clip, device=cuda).encode(package=False)
    b = TorchCodec(cfg, clip, device="cpu").encode(package=False)
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    assert a["fast_me_passes"] == b["fast_me_passes"]
    for fa, fb in zip(a["per_frame"], b["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size"):
            assert torch.equal(fa[k].cpu(), fb[k]), k
