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
from streamoptima_tpu_torch.core import fastme as FM
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import me as M
from streamoptima_tpu_torch.core.blocks import blockify
from streamoptima_tpu_torch.core import quant as Q
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


@pytest.mark.parametrize("P,H,W,nwin,nwin_c,nb,offset", [
    (4, 64, 98, 18, None, 203, 0),  # w not a multiple of 4; nb not a multiple of a CTA's eight windows
    (4, 63, 97, 18, None, 203, 1),  # odd w; the base one byte past the allocation's 16-byte alignment
    (1, 64, 97, 18, None, 1, 0),
    (1, 63, 97, 18, None, 0, 1),  # no window: nothing launched
    (4, 63, 97, 18, None, 0, 1),
    (32, 48, 96, 18, None, 61, 0),  # nref 8 under FME
    (16, 72, 128, 18, None, 150, 3),  # nref 4 under FME: several warps to a window
    (32, 40, 98, 24, 128, 37, 1),  # windows larger than a CTA's staging budget, rows cut in pieces
    (3, 21, 35, 3, 40, 77, 1),
    (2, 40, 64, 6, 5, 50, 2),  # rows narrower than a word, and rows wider than 32 words: a thread per byte
    (1, 40, 320, 4, 260, 9, 0),
])
def test_window_fetch_kernel_unaligned_planes_and_counts(cuda, P, H, W, nwin, nwin_c, nb, offset):
    """Rows and bases that are not word-aligned, 1 to 32 planes, window
    counts that leave a CTA part-filled or empty, and windows that need
    several CTAs; origins inside, on every edge, far outside and at +-2^30."""
    rng = np.random.default_rng(P * W + nb + offset)
    nc = nwin_c or nwin
    big = torch.from_numpy(rng.integers(1, 256, P * H * W + offset, dtype=np.uint8)).to(cuda)
    planes = big[offset:].view(P, H, W)
    assert planes.is_contiguous() and planes.data_ptr() % 16 == offset
    by0 = rng.integers(-nwin - 2, H + 2, nb).astype(np.int32)
    bx0 = rng.integers(-nc - 2, W + 2, nb).astype(np.int32)
    edges = [(-5, 11), (H - 3, 13), (7, -7), (9, W - 5), (-(10**6), 10**6), (2**30, -(2**30)), (0, 0),
             (H - nwin, W - nc), (-nwin, 0), (H, W), (-(2**30), 2**30), (0, W - nc + 1)]
    for k, (y, x) in enumerate(edges[:nb]):
        by0[k], bx0[k] = y, x
    by0, bx0 = torch.from_numpy(by0).to(cuda), torch.from_numpy(bx0).to(cuda)
    n0 = K.window_fetch.launches
    got = K.window_fetch(planes, by0, bx0, nwin, nwin_c)
    torch.cuda.synchronize()
    assert K.window_fetch.launches == n0 + (nb > 0)
    assert got.dtype == torch.uint8 and got.shape == (nb, P, nwin, nc)
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


# ------------------------------------------------------- the fast-ME confirm
CONFIRM_CASES = ([(fme, vbs, nref, bs, "random") for fme in (False, True) for vbs in (False, True)
                  for nref in (1, 2, 4) for bs in (8, 16)]
                 + [(fme, vbs, 2, 16, case) for fme in (False, True) for vbs in (False, True)
                    for case in ("drift", "flat", "tile", "one_column", "one_row")]
                 + [(True, True, 1, 5, "random"), (False, True, 2, 7, "drift"), (True, False, 1, 16, "wide")])


def _confirm_case(cuda, fme, vbs, nref, bs, case):
    """The confirm's arguments as ``Motion.confirm`` builds them on the
    card (``region_base``, one ``window_fetch`` of the whole frame's planes),
    for a case: random content and MVPs of either sign and parity, some far
    outside (K8); ``drift``, MVPs that walk one step a block from the origin
    past the frame's right and bottom edges; ``flat`` content (every SAD
    ties); ``tile``, the middle rows of a frame three times as tall, read at
    their frame rows; ``one_column``, a one-block-wide frame; ``one_row``, a
    one-block-tall one; ``wide``, int32 pixels of any value."""
    rng = np.random.default_rng(nref * 100 + bs + len(case) + 2 * fme + vbs)
    H, w = {"one_column": (6 * bs, bs), "one_row": (bs, 8 * bs)}.get(case, (6 * bs, 8 * bs))
    h, g_row0 = (2 * bs, 2 * bs) if case == "tile" else (H, 0)
    if case == "flat":
        refs = torch.full((nref, H, w), 77, dtype=torch.uint8, device=cuda)
        cur = torch.full((h, w), 77, dtype=torch.uint8, device=cuda)
    else:
        refs = torch.from_numpy(rng.integers(0, 256, (nref, H, w), dtype=np.uint8)).to(cuda)
        cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True) if fme else refs
    cur_blocks = blockify(cur, bs).to(torch.int32, memory_format=torch.contiguous_format)
    if case == "wide":
        cur_blocks = torch.from_numpy(rng.integers(-2**31, 2**31, tuple(cur_blocks.shape)).astype(np.int32)).to(cuda)
    nb = cur_blocks.shape[0]
    bx, by = (t.to(torch.int32) for t in M.block_origins(h, w, bs, cuda))
    y = by + g_row0
    scale = 2 if fme else 1
    if case == "drift":
        g = np.stack([np.arange(nb) + 1, np.arange(nb) // 2, np.arange(nb) % nref], 1)
    else:
        g = rng.integers(-2 * scale * bs, 2 * scale * bs + 1, (nb, 3))
        g[:, 2] = rng.integers(0, nref, nb)
        g[0], g[-1] = (5001, -4001, 0), (-2 * scale * w - 1, 2 * scale * H + 1, nref - 1)
    g = torch.from_numpy(g.astype(np.int32)).to(cuda)
    by0, bx0 = FM.region_base(g, y, bx, fme)
    win = K.window_fetch(planes.reshape(-1, H, w), by0, bx0, bs + 2)
    dims = (2 * H - 1, 2 * w - 1) if fme else (H, w)
    return win, cur_blocks, g, scale * bx, scale * y, bs, dims, fme, vbs


@pytest.mark.parametrize("fme,vbs,nref,bs,case", CONFIRM_CASES)
def test_fast_confirm_kernel_matches_plain(cuda, fme, vbs, nref, bs, case):
    """``fast_confirm`` == ``FM.confirm`` on the same device tensors, every
    output exactly, in one launch: whole-pel and FME, with and without VBS,
    nref 1, 2, 4, bs 8 and 16 (and 5, 7), MVPs past the frame's edges (K8
    blocks and quads), flat content, a tile's frame rows, one-block-wide
    and one-block-tall frames, int32 pixels of any value."""
    args = _confirm_case(cuda, fme, vbs, nref, bs, case)
    n0 = K.fast_confirm.launches
    got = K.fast_confirm(*args)
    torch.cuda.synchronize()
    assert K.fast_confirm.launches == n0 + 1
    want = FM.confirm(*args)
    assert set(got) == set(want) == {"mv", "sad", "ok"} | ({"sub_mv", "sub_sad", "sub_ok"} if vbs else set())
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    if case in ("drift", "random"):
        assert not want["ok"].all()
    if case == "flat":
        assert (want["sad"][want["ok"]] == 0).all()


def test_fast_confirm_raises_instead_of_falling_back(cuda):
    win, cur, g, X, Y, bs, dims, fme, vbs = _confirm_case(cuda, True, True, 1, 16, "random")
    with pytest.raises(ValueError, match="one device"):
        K.fast_confirm(win, cur, g.cpu(), X, Y, bs, dims, fme, vbs)
    with pytest.raises(ValueError, match="cur_blocks"):
        K.fast_confirm(win, cur.to(torch.int64), g, X, Y, bs, dims, fme, vbs)
    with pytest.raises(ValueError, match="shared memory"):  # 4096 parity planes of 64x64 blocks
        K.fast_confirm(torch.zeros((1, 4096, 66, 66), dtype=torch.uint8, device=cuda),
                       torch.zeros((1, 64, 64), dtype=torch.int32, device=cuda), g[:1].contiguous(),
                       X[:1].contiguous(), Y[:1].contiguous(), 64, dims, True, True)


# ---------------------------------- the tool matrix: VBS or FME alone, nref <= 8
@pytest.mark.parametrize("content", ["random", "flat"])
@pytest.mark.parametrize("nref", [1, 2, 3, 4, 5, 6, 7, 8])
def test_search_kernel_modes_match_plain_up_to_eight_references(cuda, nref, content):
    """Whole-pel with and without VBS, FME with and without VBS: each search
    kernel against its plain version, on random content and on all-tie
    content where the tie-break crosses references."""
    h, w, sr = 48, 64, 4
    rng = np.random.default_rng(nref)
    if content == "flat":
        cur = torch.full((h, w), 90, dtype=torch.uint8, device=cuda)
        refs = torch.full((nref, h, w), 90, dtype=torch.uint8, device=cuda)
    else:
        cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
        refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True)
    _search_equal(K.full_search(cur, refs, sr, 16), K.full_search_plain(cur, refs, sr, 16))
    for fn, plain, inp in ((K.full_search_vbs, K.full_search_vbs_plain, refs),
                           (K.full_search_fme, K.full_search_fme_plain, planes),
                           (K.full_search_fme_vbs, K.full_search_fme_vbs_plain, planes)):
        n0 = fn.launches
        got = fn(cur, inp, sr, 16)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        want = plain(cur, inp, sr, 16)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (fn.__name__, k)


@pytest.mark.parametrize("h,w,sr", [(64, 96, 8), (96, 128, 16), (48, 16, 4), (64, 64, 40)])
def test_vbs_search_kernel_matches_plain_at_other_shapes(cuda, h, w, sr):
    """One block column (no block valid, every quad valid) and a range whose
    candidates outnumber the threads."""
    rng = np.random.default_rng(h + w + sr)
    cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
    refs = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8)).to(cuda)
    got, want = K.full_search_vbs(cur, refs, sr, 16), K.full_search_vbs_plain(cur, refs, sr, 16)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("nref", [1, 3, 8])
@pytest.mark.parametrize("bound", [4, 60, 5000])
def test_fetch_kernel_modes_match_plain(cuda, bound, nref):
    """Whole-pel with the quad plane and FME without it, every case, MVs far
    past the frame too, up to eight references."""
    rng = np.random.default_rng(bound + nref)
    h, w = 64, 96
    nb = (h // 16) * (w // 16)
    refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True)
    mv = np.stack([rng.integers(-bound, bound + 1, nb), rng.integers(-bound, bound + 1, nb),
                   rng.integers(0, nref, nb)], 1).astype(np.int32)
    smv = np.stack([rng.integers(-bound, bound + 1, (nb, 4)), rng.integers(-bound, bound + 1, (nb, 4)),
                    rng.integers(0, nref, (nb, 4))], 2).astype(np.int32)
    mv, smv = torch.from_numpy(mv).to(cuda), torch.from_numpy(smv).to(cuda)
    n0 = (K.pred_fetch_vbs.launches, K.pred_fetch_fme.launches)
    got_v, got_f = K.pred_fetch_vbs(mv, smv, refs, 16), K.pred_fetch_fme(mv, planes, 16)
    torch.cuda.synchronize()
    assert (K.pred_fetch_vbs.launches, K.pred_fetch_fme.launches) == (n0[0] + 1, n0[1] + 1)
    want_v = K.pred_fetch_vbs_plain(mv, smv, refs, 16)
    assert torch.equal(got_v[0], want_v[0]) and torch.equal(got_v[1], want_v[1])
    assert torch.equal(got_f, K.pred_fetch_fme_plain(mv, planes, 16))
    assert torch.equal(K.pred_fetch(mv, refs, 16), K.pred_fetch_plain(mv, refs, 16))
    got_fv = K.pred_fetch_fme_vbs(mv, smv, planes, 16)
    want_fv = K.pred_fetch_fme_vbs_plain(mv, smv, planes, 16)
    assert torch.equal(got_fv[0], want_fv[0]) and torch.equal(got_fv[1], want_fv[1])


@pytest.mark.parametrize("fme", [False, True])
@pytest.mark.parametrize("nref", [3, 8])
def test_rowscan_pass_kernel_matches_plain_with_many_references(cuda, nref, fme):
    rng = np.random.default_rng(nref + fme)
    cur, planes = _chain_inputs(cuda, rng, 96, 256, nref, fme, "random")
    seeds = torch.from_numpy(np.stack([rng.integers(-5, 6, 6), rng.integers(-5, 6, 6), rng.integers(0, nref, 6)],
                                      1).astype(np.int32)).to(cuda)
    assert torch.equal(K.rowscan_pass(cur, planes, seeds, 16, fme), K.rowscan_pass_plain(cur, planes, seeds, 16, fme))


TOOLS = {
    "vbs": dict(search_range=8, vbs_enable=True),
    "fme": dict(search_range=8, fme_enable=True),
    "fast_vbs": dict(search_range=16, fast_me=True, vbs_enable=True),
    "fast_fme": dict(search_range=16, fast_me=True, fme_enable=True),
    "nref3": dict(search_range=8, n_ref_frames=3),
    "nref8_vbs_fme": dict(search_range=8, n_ref_frames=8, vbs_enable=True, fme_enable=True, intra_dur=10),
    "nref3_fast_vbs_fme": dict(search_range=16, n_ref_frames=3, fast_me=True, vbs_enable=True, fme_enable=True),
    "intra1_sr8_vbs": dict(search_range=8, intra_mode=1, vbs_enable=True),
    "intra1_sr16": dict(search_range=16, intra_mode=1),
    "pm1": dict(search_range=8, parallel_mode=1),
    "pm2_fast": dict(search_range=16, parallel_mode=2, fast_me=True),
    "pm2_fast_vbs_fme": dict(search_range=16, parallel_mode=2, fast_me=True, vbs_enable=True, fme_enable=True),
    "pm3": dict(search_range=8, parallel_mode=3),
    "pm3_fast": dict(search_range=16, parallel_mode=3, fast_me=True),
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_matrix_on_card_never_calls_a_plain_version(cuda, name, monkeypatch):
    """The CPU port's encode first (plain versions), then the card's with
    every ``*_plain`` function patched to raise: encode and decode on the
    card must equal it and go through the kernels only."""
    from streamoptima_tpu_torch.core import fastme as FM
    from streamoptima_tpu_torch.engine import frame_arrays_of

    kw = dict(height=64, width=96, frames=11, qp=4, intra_dur=4, lam=0.015)
    kw.update(TOOLS[name])
    cfg = CodecConfig(**kw)
    clip = synthetic_clip(64, 96, 11, seed=3)
    b = TorchCodec(cfg, clip, device="cpu").encode(package=False)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod in (K, FM):
        for attr in dir(mod):
            if attr.endswith("_plain"):
                monkeypatch.setattr(mod, attr, refuse)
    codec = TorchCodec(cfg, clip, device=cuda)
    a = codec.encode(package=False)
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    assert a.get("fast_me_passes") == b.get("fast_me_passes")
    for fa, fb in zip(a["per_frame"], b["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size", "row_bits"):
            assert torch.equal(fa[k].cpu(), fb[k]), k
    fts = a["frame_type_seq"]
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(a["per_frame"], fts)]
    dec = codec.decode(fts, [r for _, r in pairs], [[]] * len(fts), [m for m, _ in pairs])
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), b["reconstructed frames"])


# ------------------------------------------- band inputs: a mesh tile's halo band
def _band_case(cuda, rng, t, comm, nref=2, sr=4, h=64, w=96, ntile=4):
    """Tile ``t`` of a tile-4 split of random references: cur, its band (a
    halo of sr + 1 rows of each neighbour, zeros past the frame's edges, or
    the whole frames under "all_gather") and the kernels' band kwargs."""
    from streamoptima_tpu_torch.parallel.mesh import _halo_band

    h_t, halo = h // ntile, sr + 1
    frames = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    cur = torch.from_numpy(rng.integers(0, 256, (h_t, w), dtype=np.uint8)).to(cuda)
    if comm == "halo":
        band = torch.stack([_halo_band(list(f.split(h_t)), t, halo, cuda) for f in frames])
        return cur, band, {"band_row0": halo, "g_row0": t * h_t, "grid": (h, w)}
    return cur, frames, {"band_row0": t * h_t, "g_row0": t * h_t, "grid": (h, w)}


@pytest.mark.parametrize("comm", ["halo", "all_gather"])
@pytest.mark.parametrize("t", [0, 1, 3], ids=["top", "middle", "bottom"])
def test_band_search_kernel_modes_match_plain(cuda, t, comm):
    """The four search modes on a tile's band: the halos clip at the frame's
    top and bottom edges, the bounds are the frame's."""
    rng = np.random.default_rng(10 + t)
    cur, band, kw = _band_case(cuda, rng, t, comm)
    planes = M.fme_parity_planes(band, True)
    for fn, plain, inp in ((K.full_search, K.full_search_plain, band),
                           (K.full_search_vbs, K.full_search_vbs_plain, band),
                           (K.full_search_fme, K.full_search_fme_plain, planes),
                           (K.full_search_fme_vbs, K.full_search_fme_vbs_plain, planes)):
        n0 = fn.launches
        got = fn(cur, inp, 4, 16, **kw)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        want = plain(cur, inp, 4, 16, **kw)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (fn.__name__, k)


@pytest.mark.parametrize("comm", ["halo", "all_gather"])
@pytest.mark.parametrize("t", [0, 1, 3], ids=["top", "middle", "bottom"])
def test_band_fetch_kernel_modes_match_plain(cuda, t, comm):
    """The four fetch modes on a tile's band, MVs reaching into and past the
    halo and far outside the frame: cases and bounds at frame rows, reads
    past the band at its nearest row."""
    rng = np.random.default_rng(20 + t)
    cur, band, kw = _band_case(cuda, rng, t, comm)
    planes = M.fme_parity_planes(band, True)
    nb = 6
    mv = np.stack([rng.integers(-40, 41, nb), rng.integers(-30, 31, nb), rng.integers(0, 2, nb)], 1)
    smv = np.stack([rng.integers(-40, 41, (nb, 4)), rng.integers(-30, 31, (nb, 4)), rng.integers(0, 2, (nb, 4))], 2)
    mv[0, :2], smv[1, 2, :2] = (5000, -5000), (-3, 4999)
    mv, smv = torch.from_numpy(mv.astype(np.int32)).to(cuda), torch.from_numpy(smv.astype(np.int32)).to(cuda)
    for fn, plain, args in ((K.pred_fetch, K.pred_fetch_plain, (mv, band)),
                            (K.pred_fetch_vbs, K.pred_fetch_vbs_plain, (mv, smv, band)),
                            (K.pred_fetch_fme, K.pred_fetch_fme_plain, (mv, planes)),
                            (K.pred_fetch_fme_vbs, K.pred_fetch_fme_vbs_plain, (mv, smv, planes))):
        n0 = fn.launches
        got = fn(*args, 16, **kw)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        want = plain(*args, 16, **kw)
        for x, y in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert x.shape == (16, 96) and torch.equal(x, y), fn.__name__


@pytest.mark.parametrize("extra", [{}, {"vbs_enable": True, "fme_enable": True, "n_ref_frames": 2}],
                         ids=["whole_pel", "vbs_fme_nref2"])
def test_mesh_on_card_matches_cpu_and_never_calls_a_plain_version(cuda, extra, monkeypatch):
    """A (2, 4) mesh of the card against the CPU port's single-device encode,
    with every ``*_plain`` patched to raise; the sharded decode equals the
    reconstructions."""
    from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

    cfg = CodecConfig(height=64, width=96, frames=7, search_range=4, qp=4, intra_dur=3, lam=0.015, **extra)
    clip = synthetic_clip(64, 96, 7, seed=3)
    b = TorchCodec(cfg, clip, device="cpu").encode(package=False)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for attr in dir(K):
        if attr.endswith("_plain"):
            monkeypatch.setattr(K, attr, refuse)
    mesh = make_mesh(cfg, devices=[cuda] * 8)
    assert mesh.devices.shape == (2, 4)
    sc = ShardedCodec(cfg, mesh, clip)
    a = sc.encode(package=False)
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    assert a["residual size per frame"] == b["residual size per frame"]
    for fa, fb in zip(a["per_frame"], b["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "row_bits"):
            assert torch.equal(fa[k].cpu(), fb[k]), k
    from streamoptima_tpu_torch.engine import frame_arrays_of

    fts = a["frame_type_seq"]
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(a["per_frame"], fts)]
    dec = sc.decode(fts, [r for _, r in pairs], [[]] * len(fts), [m for m, _ in pairs])
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), b["reconstructed frames"])


# ------------------------------------------------ fast ME on a mesh tile
@pytest.mark.parametrize("fme", [False, True])
@pytest.mark.parametrize("t", [0, 1, 3], ids=["top", "middle", "bottom"])
def test_tile_rowscan_pass_kernel_matches_plain(cuda, t, fme):
    """``rowscan_pass`` on tile ``t`` of a tile-4 split: the tile's rows of
    cur, the whole frame's planes, seeds from zero, random (reaching into
    the tiles above and below, odd, far outside) and one pass on."""
    rng = np.random.default_rng(30 + t)
    h, w, nref, h_t = 128, 96, 2, 32
    refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True) if fme else refs
    cur = torch.from_numpy(rng.integers(0, 256, (h_t, w), dtype=np.uint8)).to(cuda)
    seeds = rng.integers(-9, 10, (2, 3)).astype(np.int32)
    seeds[:, 2] = rng.integers(0, nref, 2)
    seeds[0, :2], seeds[1, :2] = (-3, -h_t - 5), (5001, 2 * h_t + 1)
    kw = {"g_row0": t * h_t, "grid": (h, w)}
    for s in (np.zeros((2, 3), np.int32), seeds):
        s = torch.from_numpy(s).to(cuda)
        n0 = K.rowscan_pass.launches
        got = K.rowscan_pass(cur, planes, s, 16, fme, **kw)
        torch.cuda.synchronize()
        assert K.rowscan_pass.launches == n0 + 1
        assert torch.equal(got, K.rowscan_pass_plain(cur, planes, s, 16, fme, **kw))
        nxt = torch.cat([s[:1], got[:-1, -1]]).contiguous()
        assert torch.equal(K.rowscan_pass(cur, planes, nxt, 16, fme, **kw),
                           K.rowscan_pass_plain(cur, planes, nxt, 16, fme, **kw))


def _refuse_plain(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for attr in dir(K):
        if attr.endswith("_plain"):
            monkeypatch.setattr(K, attr, refuse)


@pytest.mark.parametrize("extra", [{}, {"vbs_enable": True, "fme_enable": True}], ids=["whole_pel", "vbs_fme"])
def test_fast_mesh_on_card_matches_cpu_and_never_calls_a_plain_version(cuda, extra, monkeypatch):
    """Fast ME on a (2, 2) mesh of the card against the CPU port's
    single-device encode, every ``*_plain`` patched to raise; ``rowscan_pass``
    launches two per pass (one per tile); the sharded decode equals the
    reconstructions."""
    from streamoptima_tpu_torch.engine import frame_arrays_of
    from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

    cfg = CodecConfig(height=64, width=96, frames=7, search_range=4, qp=4, intra_dur=3, lam=0.015, fast_me=True,
                      **extra)
    clip = synthetic_clip(64, 96, 7, seed=3)
    b = TorchCodec(cfg, clip, device="cpu").encode(package=False)
    _refuse_plain(monkeypatch)
    mesh = make_mesh(cfg, devices=[cuda] * 4, tile=2)
    assert mesh.devices.shape == (2, 2)
    sc = ShardedCodec(cfg, mesh, clip)
    n0 = K.rowscan_pass.launches
    a = sc.encode(package=False)
    assert K.rowscan_pass.launches - n0 == 2 * sum(a["fast_me_passes"])
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    for fa, fb in zip(a["per_frame"], b["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "row_bits"):
            assert torch.equal(fa[k].cpu(), fb[k]), k
    fts = a["frame_type_seq"]
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(a["per_frame"], fts)]
    dec = sc.decode(fts, [r for _, r in pairs], [[]] * len(fts), [m for m, _ in pairs])
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), b["reconstructed frames"])


RC_TABLES = [[9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180],
             [8000, 3500, 1800, 1000, 700, 500, 400, 300, 250, 210, 190, 170]]
RC_CASES = {
    "rc": {"rc_flag": 1},
    "promotion": {"rc_flag": 2, "intra_thresh": 1400},
    "two_pass": {"rc_flag": 1, "two_pass": True, "vbs_enable": True, "fme_enable": True},
    "roi_fast": {"roi_qp_map": np.arange(24) % 5 - 2, "fast_me": True, "vbs_enable": True},
}


@pytest.mark.parametrize("name", list(RC_CASES))
def test_rate_control_on_card_matches_cpu(cuda, name, monkeypatch):
    """Rate control, promotion, two-pass and an ROI map on the card against
    the CPU port, every ``*_plain`` patched to raise; the decode of the
    package (row QPs from the stream) equals the reconstructions."""
    from streamoptima_tpu_torch.engine import frame_arrays_of

    kw = dict(height=64, width=96, frames=6, search_range=4, qp=4, intra_dur=4, lam=0.015, target_br="60 kbps",
              qp_rate_tables=RC_TABLES, **RC_CASES[name])
    clip = synthetic_clip(64, 96, 6, seed=5)
    b = TorchCodec(CodecConfig(**kw), clip, device="cpu").encode(package=False)
    _refuse_plain(monkeypatch)
    codec = TorchCodec(CodecConfig(**kw), clip, device=cuda)
    a = codec.encode(package=False)
    for k in ("frame_type_seq", "Qp_per_row_per_frame", "residual size per frame"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    for fa, fb in zip(a["per_frame"], b["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "row_bits"):
            assert torch.equal(fa[k].cpu(), fb[k]), k
    fts = a["frame_type_seq"]
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(a["per_frame"], fts)]
    dec = codec.decode(fts, [r for _, r in pairs], a["Qp_per_row_per_frame"], [m for m, _ in pairs])
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), b["reconstructed frames"])


@pytest.mark.parametrize("name", list(RC_CASES))
def test_rate_control_on_card_mesh_matches_cpu(cuda, name, monkeypatch):
    """The same four on a (2, 2) mesh of the card, every ``*_plain``
    patched to raise: the mesh's package equals the CPU port's one-device
    package, and the mesh's decode of it (each tile its rows of the stream's
    QPs) the reconstructions."""
    from streamoptima_tpu_torch.engine import frame_arrays_of
    from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

    kw = dict(height=64, width=96, frames=6, search_range=4, qp=4, intra_dur=3, lam=0.015, target_br="60 kbps",
              qp_rate_tables=RC_TABLES, **RC_CASES[name])
    clip = synthetic_clip(64, 96, 6, seed=5)
    cfg = CodecConfig(**kw)
    b = TorchCodec(cfg, clip, device="cpu").encode(package=False)
    _refuse_plain(monkeypatch)
    mesh = make_mesh(cfg, devices=[cuda] * 4, tile=2)
    assert mesh.devices.shape == (2, 2)
    sc = ShardedCodec(cfg, mesh, clip)
    a = sc.encode(package=False)
    for k in ("frame_type_seq", "Qp_per_row_per_frame", "residual size per frame"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    for fa, fb in zip(a["per_frame"], b["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "row_bits"):
            assert torch.equal(fa[k].cpu(), fb[k]), k
    fts = a["frame_type_seq"]
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(a["per_frame"], fts)]
    dec = sc.decode(fts, [r for _, r in pairs], a["Qp_per_row_per_frame"], [m for m, _ in pairs])
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), b["reconstructed frames"])


# ------------------------- the redesigned kernels' edges: prefetched supersets, packed words, unaligned inputs
def _unaligned(t):
    """A contiguous copy of ``t`` whose first byte is not word-aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 4
    return out


def _drift_frames(content, nref, h, w):
    """References whose SAD against an all-zero block falls toward one corner,
    so each chain step moves its MVP one step that way while it stays valid."""
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = (xx + yy) if content == "drift_up_left" else (h + w - xx - yy)
    # even values <= 126: the half-pel row sums never wrap, and a half-pel average lies strictly between two
    # different neighbours, so the FME chain drifts too
    ramp = (2 * np.minimum(ramp // 10, 63)).astype(np.uint8)
    return np.stack([np.roll(ramp, 3 * r, axis=1) for r in range(nref)])


def _edge_seeds(rng, S, nref, h, w):
    seeds = rng.integers(-9, 10, (S, 3)).astype(np.int32)
    seeds[:, 2] = rng.integers(0, nref, S)
    edges = [(0, 0, 0), (-19, -2, nref - 1), (5001, -4001, 0), (-2 * w - 1, 2 * h + 1, 0), (-17, 1, 0),
             (3, -h - 18, 0), (w - 20, 2, 0), (1, h - 20, 0)]
    for s, e in enumerate(edges[:S]):
        seeds[s] = e
    return seeds


@pytest.mark.parametrize("tile", [False, True], ids=["frame", "tile"])
@pytest.mark.parametrize("content", ["drift_down_right", "drift_up_left", "flat", "random"])
@pytest.mark.parametrize("nref", [1, 4, 8])
@pytest.mark.parametrize("fme", [False, True])
def test_rowscan_pass_kernel_matches_plain_at_plane_edges(cuda, fme, nref, content, tile):
    """MVPs that drift one step a column for a whole row (so the prefetched
    supersets cross every plane edge), seeds far outside the frame and
    straddling each edge, all-tie content, nref up to 8 (the new shared
    memory budget), on the whole frame and on tile 1 of a tile-4 split."""
    rng = np.random.default_rng(nref + 10 * fme)
    h, w = 128, 512
    if content == "flat":
        refs = np.full((nref, h, w), 77, np.uint8)
    elif content == "random":
        refs = rng.integers(0, 256, (nref, h, w), dtype=np.uint8)
    else:
        refs = _drift_frames(content, nref, h, w)
    refs = torch.from_numpy(refs).to(cuda)
    planes = M.fme_parity_planes(refs, True) if fme else refs
    h_c, kw = (32, {"g_row0": 32, "grid": (h, w)}) if tile else (h, {})
    cur = (torch.from_numpy(rng.integers(0, 256, (h_c, w), dtype=np.uint8)).to(cuda) if content == "random"
           else torch.full((h_c, w), 77 if content == "flat" else 0, dtype=torch.uint8, device=cuda))
    S = h_c // 16
    for seeds in (np.zeros((S, 3), np.int32), _edge_seeds(rng, S, nref, h, w)):
        seeds = torch.from_numpy(seeds).to(cuda)
        want = K.rowscan_pass_plain(cur, planes, seeds, 16, fme, **kw)
        n0 = K.rowscan_pass.launches
        got = K.rowscan_pass(cur, planes, seeds, 16, fme, **kw)
        torch.cuda.synchronize()
        assert K.rowscan_pass.launches == n0 + 1
        assert torch.equal(got, want)
    if content == "drift_down_right" and not tile:  # the zero-seed row did drift, one step a column
        steps = (want[0, 1:, :2] - want[0, :-1, :2]).abs().cpu()
        assert int((steps == 1).all(dim=1).sum()) >= 8


@pytest.mark.parametrize("bs", [6, 8, 12, 32])
@pytest.mark.parametrize("fme", [False, True])
def test_rowscan_pass_kernel_matches_plain_at_other_block_sizes_and_unaligned(cuda, fme, bs):
    """Block sizes whose rows end in a partial word (w % 4 != 0 at bs = 6),
    bs = 32 at eight references (FME: one column prefetched, as two do not
    fit), and planes and cur that do not start on a word: the 4-byte and
    byte-load staging."""
    rng = np.random.default_rng(bs + fme)
    h, w, nref = 4 * bs, 15 * bs, 8 if bs == 32 else 2
    cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
    refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True) if fme else refs
    seeds = torch.from_numpy(_edge_seeds(rng, h // bs, nref, h, w)).to(cuda)
    want = K.rowscan_pass_plain(cur, planes, seeds, bs, fme)
    assert torch.equal(K.rowscan_pass(cur, planes, seeds, bs, fme), want)
    assert torch.equal(K.rowscan_pass(_unaligned(cur), _unaligned(planes), seeds, bs, fme), want)


@pytest.mark.parametrize("content", ["random", "flat"])
@pytest.mark.parametrize("nref", [16, 20])
@pytest.mark.parametrize("fme", [False, True])
def test_rowscan_pass_kernel_matches_plain_beyond_fourteen_references(cuda, fme, nref, content):
    """More references than a 7-bit scan index holds (9 * nref > 127): the
    winner's SAD and its first scan index are two reductions.  FME at nref 20
    prefetches one column ahead, as two do not fit."""
    rng = np.random.default_rng(nref + fme)
    h, w = 64, 256
    if content == "flat":
        cur, refs = np.full((h, w), 40, np.uint8), np.full((nref, h, w), 40, np.uint8)
    else:
        cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
        refs = rng.integers(0, 256, (nref, h, w), dtype=np.uint8)
    cur, refs = torch.from_numpy(cur).to(cuda), torch.from_numpy(refs).to(cuda)
    planes = M.fme_parity_planes(refs, True) if fme else refs
    seeds = torch.from_numpy(_edge_seeds(rng, h // 16, nref, h, w)).to(cuda)
    want = K.rowscan_pass_plain(cur, planes, seeds, 16, fme)
    assert torch.equal(K.rowscan_pass(cur, planes, seeds, 16, fme), want)
    if content == "random":
        assert int((want[..., 2] > 14).sum()) > 0  # some winners lie past the 7-bit index


@pytest.mark.parametrize("nref", list(range(1, 9)))
@pytest.mark.parametrize("fme", [False, True])
def test_rowscan_pass_fits_up_to_eight_references(cuda, nref, fme):
    """The codec's block sizes at up to eight references fit a block (0: they do not)."""
    from streamoptima_tpu_torch._build import library

    for bs in (8, 16, 32):
        assert library().so_rowscan_pass_smem(nref, bs, int(fme)) > 0


def test_rowscan_pass_refuses_what_does_not_fit(cuda):
    h, w = 64, 128
    cur = torch.zeros((h, w), dtype=torch.uint8, device=cuda)
    seeds = torch.zeros((1, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        K.rowscan_pass(cur, torch.zeros((8, 4, h, w), dtype=torch.uint8, device=cuda), seeds, 64, True)
    planes = torch.full((1, 4, h, w), 9, dtype=torch.uint8, device=cuda)
    assert torch.equal(K.rowscan_pass(cur, planes, seeds, 64, True), K.rowscan_pass_plain(cur, planes, seeds, 64, True))


@pytest.mark.parametrize("content", ["random", "flat", "gradient"])
@pytest.mark.parametrize("sr", [4, 8, 16])
def test_fme_search_kernels_match_plain_at_frame_edges(cuda, sr, content):
    """Both FME searches at sr 4, 8 and 16 on a frame whose every block row
    and column has windows past an edge, on all-tie content and on a
    gradient that puts the winners at the range's corners."""
    rng = np.random.default_rng(sr)
    h, w, nref = 80, 144, 2
    if content == "flat":
        cur, refs = np.full((h, w), 90, np.uint8), np.full((nref, h, w), 90, np.uint8)
    elif content == "gradient":
        cur = np.zeros((h, w), np.uint8)
        refs = np.stack([_drift_frames("drift_down_right", 1, h, w)[0], _drift_frames("drift_up_left", 1, h, w)[0]])
    else:
        cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
        refs = rng.integers(0, 256, (nref, h, w), dtype=np.uint8)
    cur, refs = torch.from_numpy(cur).to(cuda), torch.from_numpy(refs).to(cuda)
    planes = M.fme_parity_planes(refs, True)
    for fn, plain in ((K.full_search_fme, K.full_search_fme_plain), (K.full_search_fme_vbs, K.full_search_fme_vbs_plain)):
        n0 = fn.launches
        got = fn(cur, planes, sr, 16)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        want = plain(cur, planes, sr, 16)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (fn.__name__, k)


@pytest.mark.parametrize("sr", [4, 8, 16])
def test_fme_band_search_kernels_match_plain(cuda, sr):
    """A middle tile's halo band (band_row0 = sr + 1, g_row0 != 0) and the
    whole frames read at band_row0 = g_row0."""
    rng = np.random.default_rng(20 + sr)
    for comm in ("halo", "all_gather"):
        cur, band, kw = _band_case(cuda, rng, 1, comm, sr=sr, h=128, w=112)
        planes = M.fme_parity_planes(band, True)
        for fn, plain in ((K.full_search_fme, K.full_search_fme_plain),
                          (K.full_search_fme_vbs, K.full_search_fme_vbs_plain)):
            got, want = fn(cur, planes, sr, 16, **kw), plain(cur, planes, sr, 16, **kw)
            for k in want:
                assert torch.equal(got[k], want[k]), (comm, fn.__name__, k)


@pytest.mark.parametrize("bs", [6, 8, 12])
def test_fme_search_kernels_match_plain_at_other_block_sizes_and_unaligned(cuda, bs):
    """Rows that end in a partial word and quads whose halves straddle a word
    (bs 6 and 12), w % 4 != 0, and planes and cur that do not start on a
    word: the byte-load staging."""
    rng = np.random.default_rng(40 + bs)
    h, w, nref, sr = 5 * bs, 9 * bs, 3, 5
    cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
    refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True)
    for fn, plain in ((K.full_search_fme, K.full_search_fme_plain), (K.full_search_fme_vbs, K.full_search_fme_vbs_plain)):
        want = plain(cur, planes, sr, bs)
        for c, p in ((cur, planes), (_unaligned(cur), _unaligned(planes))):
            got = fn(c, p, sr, bs)
            for k in want:
                assert torch.equal(got[k], want[k]), (fn.__name__, k)


@pytest.mark.parametrize("sr,bs", [(4, 208), (16, 188)])
def test_fme_search_kernels_match_plain_at_the_largest_blocks(cuda, sr, bs):
    """The largest even block size the budget takes at sr 4 and 16: a
    reference's four windows do not fit a block, so the kernel stages one
    plane at a time."""
    rng = np.random.default_rng(60 + sr)
    h = w = 3 * bs
    cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
    refs = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True)
    for fn, plain in ((K.full_search_fme, K.full_search_fme_plain), (K.full_search_fme_vbs, K.full_search_fme_vbs_plain)):
        want = plain(cur, planes, sr, bs)
        assert bool(want["ok"].any())
        got = fn(cur, planes, sr, bs)
        for k in want:
            assert torch.equal(got[k], want[k]), (fn.__name__, k)


# ------------------------- the whole-pel search's edges: packed words, warps per CTA, budgets, bands
def _whole_search_pairs(vbs):
    return ((K.full_search_vbs, K.full_search_vbs_plain) if vbs else (K.full_search, K.full_search_plain))


def _assert_search_equal(got, want, what=""):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


def _random_search_inputs(cuda, seed, h, w, nref):
    rng = np.random.default_rng(seed)
    cur = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda)
    refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    return cur, refs


@pytest.mark.parametrize("vbs", [False, True], ids=["full", "vbs"])
@pytest.mark.parametrize("sr", [1, 4, 8, 16, 32, 63, 127])
def test_whole_pel_search_kernels_match_plain_at_every_range(cuda, sr, vbs):
    """Ranges from 1 to the key's limit of 127 on a 5 x 7 block frame (35
    macroblocks, not a multiple of the warps a CTA takes): groups of four
    column offsets that end in a partial group, and windows far past every
    edge."""
    fn, plain = _whole_search_pairs(vbs)
    cur, refs = _random_search_inputs(cuda, 100 + sr, 80, 112, 2)
    n0 = fn.launches
    got = fn(cur, refs, sr, 16)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    _assert_search_equal(got, plain(cur, refs, sr, 16), sr)


@pytest.mark.parametrize("bs,vbs", [(4, False), (4, True), (5, False), (6, False), (6, True), (8, False),
                                    (8, True), (12, False), (12, True), (16, False), (16, True), (32, False),
                                    (32, True)])
def test_whole_pel_search_kernels_match_plain_at_other_block_sizes_and_unaligned(cuda, bs, vbs):
    """Block sizes whose rows end in a partial word (5, 6) and whose quad
    halves straddle a word (6, 12), odd sizes without VBS only; w = 7 bs, not
    a multiple of 4 at bs 5 and 6; and cur and refs that do not start on a
    word (a view one byte into a larger buffer): the byte-load staging."""
    fn, plain = _whole_search_pairs(vbs)
    cur, refs = _random_search_inputs(cuda, 200 + bs, 5 * bs, 7 * bs, 3)
    want = plain(cur, refs, 5, bs)
    assert bool(want["ok"].any())
    for c, r in ((cur, refs), (_unaligned(cur), _unaligned(refs))):
        _assert_search_equal(fn(c, r, 5, bs), want, (bs, c.data_ptr() % 4))


@pytest.mark.parametrize("vbs", [False, True], ids=["full", "vbs"])
@pytest.mark.parametrize("nref", [1, 4, 8])
def test_whole_pel_search_kernels_match_plain_at_one_four_and_eight_references(cuda, nref, vbs):
    """One window buffer (nref 1) or two, the next reference's copied while
    one is summed; the winner's pixels from the staged window or from device
    memory; aligned and unaligned references."""
    fn, plain = _whole_search_pairs(vbs)
    cur, refs = _random_search_inputs(cuda, 300 + nref, 64, 96, nref)
    want = plain(cur, refs, 8, 16)
    if nref > 1:
        assert len(set(want["mv"][:, 2].tolist())) > 1  # winners from several references
    for r in (refs, _unaligned(refs)):
        _assert_search_equal(fn(cur, r, 8, 16), want, nref)


@pytest.mark.parametrize("vbs", [False, True], ids=["full", "vbs"])
@pytest.mark.parametrize("content", ["flat", "stripes", "black_vs_white"])
def test_whole_pel_search_kernels_break_ties_like_plain(cuda, content, vbs):
    """All-tie content over three identical references (ties within a lane's
    four candidates, across lanes and across references: the least l1, then
    reference, then dx, then dy wins), columns of period two (every other
    candidate ties), and black against white (every SAD the largest)."""
    fn, plain = _whole_search_pairs(vbs)
    h, w, nref = 64, 80, 3
    if content == "flat":
        cur, refs = np.full((h, w), 90, np.uint8), np.full((nref, h, w), 90, np.uint8)
    elif content == "stripes":
        row = np.where(np.arange(w) % 2 == 0, 30, 200).astype(np.uint8)
        cur = np.broadcast_to(row, (h, w)).copy()
        refs = np.broadcast_to(row, (nref, h, w)).copy()
    else:
        cur, refs = np.zeros((h, w), np.uint8), np.full((nref, h, w), 255, np.uint8)
    cur, refs = torch.from_numpy(cur).to(cuda), torch.from_numpy(refs).to(cuda)
    _assert_search_equal(fn(cur, refs, 8, 16), plain(cur, refs, 8, 16), content)


@pytest.mark.parametrize("h,w", [(16, 16), (16, 48), (32, 16)])
def test_whole_pel_search_kernels_with_blocks_that_have_no_candidate(cuda, h, w):
    """Frames so small that no candidate is valid for a 16 x 16 block on some
    axis while its top-left quads still have some: mv (0, 0, 0), sad
    INT32_MAX, ok False and a zero pred where none is valid."""
    cur, refs = _random_search_inputs(cuda, h + w, h, w, 2)
    for vbs in (False, True):
        fn, plain = _whole_search_pairs(vbs)
        want = plain(cur, refs, 4, 16)
        assert not bool(want["ok"].any())
        if vbs:
            assert bool(want["sub_ok"].any())
        _assert_search_equal(fn(cur, refs, 4, 16), want, (h, w, vbs))


@pytest.mark.parametrize("vbs", [False, True], ids=["full", "vbs"])
@pytest.mark.parametrize("t", [0, 1, 2], ids=["top", "middle", "bottom"])
def test_whole_pel_band_search_kernels_match_plain_on_a_tile_three_split(cuda, t, vbs):
    """The top, middle and bottom band of a tile-3 split (halo of sr + 1 rows,
    zero rows past the frame), and the whole frames at the tile's row."""
    fn, plain = _whole_search_pairs(vbs)
    rng = np.random.default_rng(400 + t)
    for comm in ("halo", "all_gather"):
        cur, band, kw = _band_case(cuda, rng, t, comm, nref=2, sr=8, h=96, w=112, ntile=3)
        _assert_search_equal(fn(cur, band, 8, 16, **kw), plain(cur, band, 8, 16, **kw), (comm, t))


@pytest.mark.parametrize("vbs,sr,bs", [(False, 8, 212), (False, 63, 184), (True, 8, 332), (True, 63, 272)])
def test_whole_pel_search_kernels_match_plain_at_the_largest_blocks(cuda, vbs, sr, bs):
    """The largest block each wrapper's budget takes at sr 8 and 63
    (``tests/test_torch_kernel_limits.py``): at VBS (63, 272) the block's
    words do not fit beside the window, so its rows are read from device
    memory."""
    fn, plain = _whole_search_pairs(vbs)
    cur, refs = _random_search_inputs(cuda, 500 + bs, 2 * bs, 2 * bs, 2)
    want = plain(cur, refs, sr, bs)
    assert bool(want["ok"].any())
    _assert_search_equal(fn(cur, refs, sr, bs), want, (sr, bs))


def test_whole_pel_search_launches_the_largest_block_of_every_range(cuda):
    """The largest block each wrapper's budget takes at every range from 1 to
    127 launches (a block's layout grows with bs, so every smaller block fits
    too; more references only add a second window where it fits): the
    kernel refuses no shape its wrappers take.  A one-block frame has no
    valid candidate for the block."""
    for vbs in (False, True):
        fn = _whole_search_pairs(vbs)[0]
        step = 2 if vbs else 1
        for sr in range(1, 128):
            bs = step
            while K._search_smem(sr, bs + step, vbs) <= K._SMEM_LIMIT:
                bs += step
            cur = torch.zeros((bs, bs), dtype=torch.uint8, device=cuda)
            got = fn(cur, torch.zeros((1, bs, bs), dtype=torch.uint8, device=cuda), sr, bs)
            torch.cuda.synchronize()
            assert not bool(got["ok"].any()) and int(got["sad"][0]) == 2**31 - 1, (vbs, sr, bs)


# ------------------------- the prediction fetch's edges: segments, case boundaries, store widths
def _fetch_fns(mode):
    fme, vbs = "fme" in mode, "vbs" in mode
    name = "pred_fetch" + ("_fme" if fme else "") + ("_vbs" if vbs else "")
    return getattr(K, name), getattr(K, name + "_plain"), fme, vbs


def _fetch_args(mv, smv, refs, vbs):
    return (mv, smv, refs) if vbs else (mv, refs)


def _assert_fetch_equal(got, want, what=""):
    for x, y in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert x.shape == y.shape and torch.equal(x, y), what


def _boundary_mvs(rng, x0, y0, n, h, w, fme):
    """MVs for the n x n (sub)blocks at (x0, y0) that put each window's near
    or far edge on either side of the FME case boundaries (the primary
    bounds, last valid origin D - n - 1, and the margin, D - 3n - 1) and of
    the frame's edges whole-pel; every third one random."""
    scale = 2 if fme else 1
    W, H = scale * w - (scale - 1), scale * h - (scale - 1)

    def edges(D):
        return np.array([-n, -1, 0, D - 3 * n - 1, D - 3 * n, D - n - 1, D - n, D - n + 1, D - 1, D])

    mv = np.stack([rng.choice(edges(W), len(x0)) - scale * x0, rng.choice(edges(H), len(y0)) - scale * y0,
                   np.zeros(len(x0), np.int64)], 1)
    mv[::3, :2] = rng.integers(-3 * n, 3 * n + 1, (len(mv[::3]), 2))
    return mv


@pytest.mark.parametrize("mode", ["whole", "vbs", "fme", "fme_vbs"])
@pytest.mark.parametrize("bs", [6, 8, 12, 16, 32])
def test_fetch_kernel_modes_match_plain_at_other_block_sizes_and_case_boundaries(cuda, bs, mode):
    """Each mode at block sizes whose segments are short (6, 12) or several
    per row (32), with MVs on each side of the FME case A / B / C boundaries
    and of the frame's edges, for the blocks and for each quad; w = 7 bs is
    not a multiple of 8 at bs 6 and 12 (scalar stores), and planes that do
    not start on a word (byte loads)."""
    fn, plain, fme, vbs = _fetch_fns(mode)
    rng = np.random.default_rng(600 + bs)
    h, w, nref = 5 * bs, 7 * bs, 3
    refs = torch.from_numpy(rng.integers(0, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True) if fme else refs
    nb, nbc, s = (h // bs) * (w // bs), w // bs, bs // 2
    bx, by = np.arange(nb) % nbc * bs, np.arange(nb) // nbc * bs
    mv = _boundary_mvs(rng, bx, by, bs, h, w, fme)
    mv[:, 2] = rng.integers(0, nref, nb)
    q = np.arange(4)
    qx, qy = (bx[:, None] + (q & 1) * s).reshape(-1), (by[:, None] + (q >> 1) * s).reshape(-1)
    smv = _boundary_mvs(rng, qx, qy, s, h, w, fme).reshape(nb, 4, 3)
    smv[..., 2] = rng.integers(0, nref, (nb, 4))
    mv = torch.from_numpy(mv.astype(np.int32)).to(cuda)
    smv = torch.from_numpy(smv.astype(np.int32)).to(cuda)
    want = plain(*_fetch_args(mv, smv, planes, vbs), bs)
    for p in (planes, _unaligned(planes)):
        n0 = fn.launches
        got = fn(*_fetch_args(mv, smv, p, vbs), bs)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        _assert_fetch_equal(got, want, (bs, mode))


@pytest.mark.parametrize("mode", ["whole", "vbs", "fme", "fme_vbs"])
def test_fetch_kernel_modes_write_zeros_for_a_reference_out_of_range(cuda, mode):
    """A reference index below 0 or at or past nref gives zeros (the host
    rejects such streams; the kernel stays memory-safe); every other
    (sub)block is the plain version's."""
    fn, plain, fme, vbs = _fetch_fns(mode)
    rng = np.random.default_rng(700)
    h, w, nref, bs = 48, 64, 2, 16
    refs = torch.from_numpy(rng.integers(1, 256, (nref, h, w), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True) if fme else refs
    nb = (h // bs) * (w // bs)
    mv = np.stack([rng.integers(-6, 7, nb), rng.integers(-6, 7, nb), rng.integers(0, nref, nb)], 1)
    smv = np.stack([rng.integers(-6, 7, (nb, 4)), rng.integers(-6, 7, (nb, 4)), rng.integers(0, nref, (nb, 4))], 2)
    bad, bad_q = np.array([1, 5, 9]), np.array([[2, 1], [4, 3], [7, 0]])
    mv_bad, smv_bad = mv.copy(), smv.copy()
    mv_bad[bad, 2] = (-1, nref, 1000)
    smv_bad[bad_q[:, 0], bad_q[:, 1], 2] = (nref, -7, 2**30)

    def to(a):
        return torch.from_numpy(a.astype(np.int32)).to(cuda)

    want = plain(*_fetch_args(to(mv), to(smv), planes, vbs), bs)
    got = fn(*_fetch_args(to(mv_bad), to(smv_bad), planes, vbs), bs)
    want, got = (want if vbs else (want,)), (got if vbs else (got,))
    blk = torch.zeros(nb, dtype=torch.bool)
    blk[bad] = True
    full_bad = blk.reshape(h // bs, 1, w // bs, 1).expand(-1, bs, -1, bs).reshape(h, w).to(cuda)
    assert torch.equal(got[0], torch.where(full_bad, 0, want[0]).to(torch.int16))
    if vbs:
        q = torch.zeros(nb, 4, dtype=torch.bool)
        q[bad_q[:, 0], bad_q[:, 1]] = True
        s = bs // 2
        quad_bad = q.reshape(h // bs, w // bs, 2, 2).permute(0, 2, 1, 3).reshape(h // s, 1, w // s, 1)
        quad_bad = quad_bad.expand(-1, s, -1, s).reshape(h, w).to(cuda)
        assert torch.equal(got[1], torch.where(quad_bad, 0, want[1]).to(torch.int16))


@pytest.mark.parametrize("mode", ["whole", "vbs", "fme", "fme_vbs"])
@pytest.mark.parametrize("t", [0, 1, 2], ids=["top", "middle", "bottom"])
def test_band_fetch_kernel_modes_clamp_to_the_band_on_a_tile_three_split(cuda, t, mode):
    """MVs whose rows lie in the frame but past the band's halo on either
    side, and past the frame: the band's nearest row, or zeros; the top,
    middle and bottom tile of a tile-3 split."""
    fn, plain, fme, vbs = _fetch_fns(mode)
    rng = np.random.default_rng(800 + t)
    cur, band, kw = _band_case(cuda, rng, t, "halo", nref=2, sr=4, h=96, w=112, ntile=3)
    planes = M.fme_parity_planes(band, True) if fme else band
    scale = 2 if fme else 1
    nb = cur.shape[0] // 16 * (112 // 16)
    reach = scale * 48
    mv = np.stack([rng.integers(-24, 25, nb), rng.integers(-reach, reach + 1, nb), rng.integers(0, 2, nb)], 1)
    mv[:3, 1] = (-reach, reach, scale * 9)  # far above, far below, just past the halo
    smv = np.stack([rng.integers(-24, 25, (nb, 4)), rng.integers(-reach, reach + 1, (nb, 4)),
                    rng.integers(0, 2, (nb, 4))], 2)
    mv, smv = torch.from_numpy(mv.astype(np.int32)).to(cuda), torch.from_numpy(smv.astype(np.int32)).to(cuda)
    _assert_fetch_equal(fn(*_fetch_args(mv, smv, planes, vbs), 16, **kw),
                        plain(*_fetch_args(mv, smv, planes, vbs), 16, **kw), (t, mode))


@pytest.mark.parametrize("allow_tf32", [True, False])
def test_device_ssim_matches_host_at_720p(cuda, allow_tf32, monkeypatch):
    """``metrics.ssim_frames`` on the card against the float64 host ``ssim``
    at 720p, two frames, within 1e-6, with cuDNN's TF32 allowed or not: the
    window sums are int32 adds, so the switch changes nothing."""
    from streamoptima_tpu_torch import metrics

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", allow_tf32)
    clip = synthetic_clip(720, 1280, 3)
    rng = np.random.default_rng(720)
    noisy = np.clip(clip[1:].astype(np.int32) + rng.integers(-5, 5, clip[1:].shape), 0, 255).astype(np.uint8)
    got = metrics.ssim_frames(clip[:2], noisy, device=cuda)
    host = [metrics.ssim(a, b) for a, b in zip(clip[:2], noisy)]
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-6)


# ------------------------------------------ the compat engine: dct_scipy, K18
def _dct_cases(rng, n: int, nb: int) -> dict:
    """Residual blocks (random, half-integer DC ties, the extremes) and the
    coefficients the IDCT takes (random in the codec's range)."""
    x = rng.integers(-255, 256, (nb, n, n)).astype(np.int64)
    ties = x.copy()
    ties[:, 0, 0] -= (ties.sum(axis=(1, 2)) - n // 2) % n
    x[0], x[-1] = 255, -255  # one block: -255 alone
    return {"dct": (x, ties), "idct": (rng.integers(-8192, 8193, (nb, n, n)).astype(np.int64),
                                       (np.round(rng.standard_normal((nb, n, n)) * 64) * 2 ** (rng.integers(
                                           0, 8, (nb, 1, 1)))).astype(np.int64))}


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("nb", [1, 7, 396, 1584])
def test_dct_scipy_kernel_matches_plain(cuda, n, nb):
    """Both directions, bit for bit with the plain version on the card (the
    same float64 operations in the same order), one launch each; the CPU's
    plain version agrees (CUDA's float64 adds and multiplies round as the
    CPU's)."""
    rng = np.random.default_rng(n * nb)
    for direction, sets in _dct_cases(rng, n, nb).items():
        inverse = direction == "idct"
        for a in sets:
            t = torch.from_numpy(a).to(cuda)
            n0 = K.dct_scipy.launches
            got = K.dct_scipy(t, inverse)
            torch.cuda.synchronize()
            assert K.dct_scipy.launches == n0 + 1
            assert torch.equal(got, K.dct_scipy_plain(t, inverse)), direction
            assert torch.equal(got.cpu(), K.dct_scipy_plain(torch.from_numpy(a), inverse)), direction


def test_dct_scipy_kernel_refuses_other_sizes(cuda):
    with pytest.raises(ValueError, match="8 x 8 and 16 x 16"):
        K.dct_scipy(torch.zeros((3, 4, 4), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="int64"):
        K.dct_scipy(torch.zeros((3, 8, 8), dtype=torch.int32, device=cuda))
    n0 = K.dct_scipy.launches
    assert K.dct_scipy(torch.zeros((0, 16, 16), dtype=torch.int64, device=cuda)).shape == (0, 16, 16)
    assert K.dct_scipy.launches == n0


@pytest.mark.parametrize("margin", [None, 8, 16])
def test_fme_quad_fetch_margin_matches_plain(cuda, margin):
    """Kernel 3's quad margin (K18: the compat reconstruction passes the
    parent block's size) against the plain version, MVs on both sides of
    every case boundary; the wrapper counts a launch at a margin other than
    the quads' own size apart."""
    rng = np.random.default_rng(18)
    h, w, nb = 64, 96, 24
    planes = M.fme_parity_planes(torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8)).to(cuda),
                                 wrap_row_pass=True)
    mv = torch.from_numpy(np.stack([rng.integers(-40, 41, nb), rng.integers(-40, 41, nb), rng.integers(0, 2, nb)],
                                   1).astype(np.int32)).to(cuda)
    smv = np.stack([rng.integers(-40, 41, (nb, 4)), rng.integers(-40, 41, (nb, 4)), rng.integers(0, 2, (nb, 4))],
                   -1).astype(np.int32)
    smv = torch.from_numpy(smv).to(cuda)
    n0, m0 = K.pred_fetch_fme_vbs.launches, K.pred_fetch_fme_vbs.margin_launches
    got = K.pred_fetch_fme_vbs(mv, smv, planes, 16, quad_margin=margin)
    assert K.pred_fetch_fme_vbs.launches == n0 + 1
    assert K.pred_fetch_fme_vbs.margin_launches == m0 + (margin == 16)
    want = K.pred_fetch_fme_vbs_plain(mv, smv, planes, 16, quad_margin=margin)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


COMPAT = {
    "whole_pel": dict(search_range=4),
    "vbs_fme": dict(search_range=4, vbs_enable=True, fme_enable=True),
    "fast_vbs_fme": dict(search_range=16, fast_me=True, vbs_enable=True, fme_enable=True),
    "rc2_promote": dict(search_range=4, rc_flag=2, target_br="60 kbps", qp_rate_tables=RC_TABLES, intra_thresh=300),
    "pm1": dict(search_range=4, parallel_mode=1),
    "pm2_fast_vbs": dict(search_range=16, parallel_mode=2, fast_me=True, vbs_enable=True),
    "pm3_nref2_fme": dict(search_range=4, parallel_mode=3, n_ref_frames=2, fme_enable=True),
}


@pytest.mark.parametrize("name", list(COMPAT))
def test_compat_on_card_matches_cpu_and_never_calls_a_plain_version(cuda, name, monkeypatch):
    """CompatCodec on the card against the CPU port (held to the JAX
    package's CompatCodec by tests/test_torch_compat.py), every ``*_plain``
    patched to raise: the package (PSNR and MAE exactly) and the decode."""
    from streamoptima_tpu_torch.compat_engine import CompatCodec

    cfg = CodecConfig(height=64, width=96, frames=6, qp=4, intra_dur=3, lam=0.015, engine="compat", **COMPAT[name])
    clip = synthetic_clip(64, 96, 6, seed=7)
    b = CompatCodec(cfg, clip, device="cpu").encode()
    _refuse_plain(monkeypatch)
    codec = CompatCodec(cfg, clip, device=cuda)
    n0 = K.dct_scipy.launches
    a = codec.encode()
    assert K.dct_scipy.launches > n0
    for k in ("frame_type_seq", "Qp_per_row_per_frame", "residual size per frame", "PSNR per frame",
              "MAE per Frame", "MVS per Frame", "fast_me_passes"):
        assert a.get(k) == b.get(k), k
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    for fa, fb in zip(a["approx residual"], b["approx residual"]):
        for (sa, qa), (sb, qb) in zip(fa, fb):
            assert sa == sb and np.array_equal(np.stack(qa) if sa else qa, np.stack(qb) if sb else qb)
    dec = codec.decode(a["frame_type_seq"], a["approx residual"], a["Qp_per_row_per_frame"], a["MVS per Frame"])
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), b["reconstructed frames"])


# ------------------------------------------------ intra reconstruction (csrc/intra_recon.cu)
def _intra_case(cuda, rng, nbr, nbc, bs, sr, vbs, dtype=np.int32):
    """Random intra_recon inputs: residuals in +-4080, random splits, MVs in
    [-sr, 0] and, for about a third, out of range (int32 extremes too)."""
    nb, s = nbr * nbc, bs // 2
    mv = np.where(rng.random(nb) < 0.3, rng.integers(-sr - 9, 10, nb), rng.integers(-sr, 1, nb))
    smv = np.where(rng.random((nb, 4)) < 0.3, rng.integers(-sr - 9, 10, (nb, 4)), rng.integers(-sr, 1, (nb, 4)))
    mv[0], smv[0, 0] = 2**31 - 1, -(2**31)
    out = [torch.from_numpy(rng.integers(-4080, 4081, (nb, bs, bs)).astype(dtype)).to(cuda),
           torch.from_numpy(mv.astype(np.int32)).to(cuda)]
    if vbs:
        out += [torch.from_numpy(rng.integers(-4080, 4081, (nb, 4, s, s)).astype(dtype)).to(cuda),
                torch.from_numpy(rng.random(nb) < 0.5).to(cuda), torch.from_numpy(smv.astype(np.int32)).to(cuda)]
    return out


def _intra_equal(cuda, a, h, w, bs, sr, transpose=False):
    n0 = K.intra_recon.launches
    got = K.intra_recon(a[0], a[1], h, w, bs, sr, *a[2:], transpose=transpose)
    torch.cuda.synchronize()
    assert K.intra_recon.launches == n0 + 1
    assert got.dtype == torch.uint8 and got.shape == (h, w) and got.device.type == "cuda"
    assert torch.equal(got, K.intra_recon_plain(a[0], a[1], h, w, bs, sr, *a[2:], transpose=transpose))


@pytest.mark.parametrize("vbs", [False, True], ids=["full", "vbs"])
@pytest.mark.parametrize("bs,sr", [(bs, sr) for bs in (8, 16) for sr in (1, bs // 2, bs - 1, bs, bs + 1, 2 * bs + 3)]
                         + [(16, 127), (8, 127)])
def test_intra_recon_kernel_matches_plain(cuda, bs, sr, vbs):
    """Both layouts (intra mode 0, and mode 1's transposed call), corrupt MVs included."""
    rng = np.random.default_rng(bs * 1000 + sr * 2 + vbs)
    _intra_equal(cuda, _intra_case(cuda, rng, 3, 5, bs, sr, vbs), 3 * bs, 5 * bs, bs, sr)
    _intra_equal(cuda, _intra_case(cuda, rng, 5, 3, bs, sr, vbs), 3 * bs, 5 * bs, bs, sr, transpose=True)


@pytest.mark.parametrize("vbs", [False, True], ids=["full", "vbs"])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("nbr,nbc", [(1, 9), (6, 1), (1, 1), (2, 90)], ids=["one_row", "one_column", "one_block",
                                                                            "wider_than_the_ring"])
def test_intra_recon_kernel_matches_plain_at_edge_shapes(cuda, nbr, nbc, bs, vbs):
    rng = np.random.default_rng(nbr * 100 + nbc + bs)
    for sr in (bs // 2, bs + 1, 127):
        _intra_equal(cuda, _intra_case(cuda, rng, nbr, nbc, bs, sr, vbs), nbr * bs, nbc * bs, bs, sr)
        _intra_equal(cuda, _intra_case(cuda, rng, nbc, nbr, bs, sr, vbs), nbr * bs, nbc * bs, bs, sr, True)


@pytest.mark.parametrize("bs,vbs", [(4, True), (6, True), (5, False), (12, True), (32, True), (32, False)])
def test_intra_recon_kernel_matches_plain_at_other_block_sizes(cuda, bs, vbs):
    rng = np.random.default_rng(bs)
    for sr in (1, bs, 2 * bs + 1, 256 - bs):
        _intra_equal(cuda, _intra_case(cuda, rng, 3, 7, bs, sr, vbs), 3 * bs, 7 * bs, bs, sr)


@pytest.mark.parametrize("sr", [8, 16])
def test_intra_recon_kernel_takes_int64_residuals(cuda, sr):
    """The compat engine's int64 residuals, some beyond int32: the kernel's
    int32 cast does not change the wrapped frame."""
    rng = np.random.default_rng(sr)
    a = _intra_case(cuda, rng, 4, 6, 16, sr, True, np.int64)
    a[0] = a[0] + torch.from_numpy(rng.integers(-3, 4, tuple(a[0].shape)) * 2**32).to(cuda)
    _intra_equal(cuda, a, 64, 96, 16, sr)


@pytest.mark.parametrize("transpose", [False, True], ids=["mode0", "mode1"])
def test_intra_recon_kernel_matches_plain_at_720p(cuda, transpose):
    rng = np.random.default_rng(720 + transpose)
    nbr, nbc = (80, 45) if transpose else (45, 80)
    _intra_equal(cuda, _intra_case(cuda, rng, nbr, nbc, 16, 16, True), 720, 1280, 16, 16, transpose)


def test_intra_recon_kernel_refuses_what_it_does_not_take(cuda):
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=cuda)

    n0 = K.intra_recon.launches
    with pytest.raises(ValueError, match="sr \\+ bs <= 256"):
        K.intra_recon(z(4, 16, 16), z(4), 32, 32, 16, 241)
    with pytest.raises(ValueError, match="even under VBS"):
        K.intra_recon(z(4, 5, 5), z(4), 10, 10, 5, 4, z(4, 4, 2, 2), torch.zeros(4, dtype=torch.bool, device=cuda),
                      z(4, 4))
    with pytest.raises(ValueError, match="bs=48"):
        K.intra_recon(z(1, 48, 48), z(1), 48, 48, 48, 4)
    assert K.intra_recon.launches == n0


INTRA_ENGINES = {
    "fast_vbs_fme_sr16": dict(search_range=16, fast_me=True, vbs_enable=True, fme_enable=True),
    "intra1_vbs_sr16": dict(search_range=16, vbs_enable=True, intra_mode=1),
    "compat_vbs_fme_sr16": dict(search_range=16, vbs_enable=True, fme_enable=True, engine="compat"),
}


@pytest.mark.parametrize("name", list(INTRA_ENGINES))
def test_intra_recon_on_card_engines_match_cpu(cuda, name, monkeypatch):
    """An sr = 16 encode and decode on the card, every ``*_plain`` patched
    to raise, equal the CPU port bit for bit; each intra frame is one
    ``intra_recon`` launch in the encode and one in the decode."""
    from streamoptima_tpu_torch.compat_engine import CompatCodec
    from streamoptima_tpu_torch.engine import frame_arrays_of

    cfg = CodecConfig(height=64, width=96, frames=7, qp=4, intra_dur=3, lam=0.015, **INTRA_ENGINES[name])
    clip = synthetic_clip(64, 96, 7, seed=11)
    compat = cfg.engine == "compat"
    codec_cls = CompatCodec if compat else TorchCodec
    b = codec_cls(cfg, clip, device="cpu")
    bp = b.encode() if compat else b.encode(package=False)
    _refuse_plain(monkeypatch)
    codec = codec_cls(cfg, clip, device=cuda)
    n0 = K.intra_recon.launches
    a = codec.encode() if compat else codec.encode(package=False)
    fts = a["frame_type_seq"]
    assert fts == bp["frame_type_seq"] and K.intra_recon.launches - n0 == fts.count(0) == 3
    np.testing.assert_array_equal(a["reconstructed frames"], bp["reconstructed frames"])
    if compat:
        assert a["MVS per Frame"] == bp["MVS per Frame"]
        dec = codec.decode(fts, a["approx residual"], a["Qp_per_row_per_frame"], a["MVS per Frame"])
    else:
        for fa, fb in zip(a["per_frame"], bp["per_frame"]):
            for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size", "recon"):
                assert torch.equal(fa[k].cpu(), fb[k]), k
        pairs = [frame_arrays_of(o, ft) for o, ft in zip(a["per_frame"], fts)]
        dec = codec.decode(fts, [r for _, r in pairs], [[]] * len(fts), [m for m, _ in pairs])
    assert K.intra_recon.launches - n0 == 2 * fts.count(0)
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), bp["reconstructed frames"])


# ------------------------------------------------ residual coding: transform_select, residual_recon, intra_search
def _to(cuda, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)


def _checkerboards(bs):
    i, j = np.indices((bs, bs))
    out = [np.where(((i // p) + (j // p)) % 2 == 0, 255, -255) for p in (1, 2, 4)]
    return out + [-c for c in out] + [np.full((bs, bs), 255), np.full((bs, bs), -255), np.zeros((bs, bs), int)]


def _select_case(cuda, rng, nb, bs):
    """Residuals (dense, sparse, ±255 checkerboards, zero blocks), SADs with
    INT32_MAX where no candidate is valid (``sad_masked``, the searches'
    outputs, passed with their ok flags) or all valid (``sad``, passed
    without), QPs in [0, 12]."""
    s = bs // 2
    res = rng.integers(-255, 256, (nb, bs, bs)) * (rng.random((nb, 1, 1)) < rng.random((nb, bs, bs)))
    ch = _checkerboards(bs)
    res[: len(ch)] = ch
    quads = res.reshape(nb, 2, s, 2, s).swapaxes(2, 3).reshape(nb, 4, s, s).copy()
    quads[1::3] = rng.integers(-255, 256, quads[1::3].shape)
    ok, sub_ok = rng.random(nb) < 0.85, rng.random((nb, 4)) < 0.85
    sad, sub_sad = rng.integers(0, 255 * bs * bs + 1, nb), rng.integers(0, 255 * s * s + 1, (nb, 4))
    sad_m, sub_sad_m = np.where(ok, sad, 2**31 - 1), np.where(sub_ok, sub_sad, 2**31 - 1)
    return {"res": _to(cuda, res.astype(np.int32)), "quads": _to(cuda, quads.astype(np.int32)),
            "sad": _to(cuda, sad.astype(np.int32)), "sub_sad": _to(cuda, sub_sad.astype(np.int32)),
            "sad_masked": _to(cuda, sad_m.astype(np.int32)), "sub_sad_masked": _to(cuda, sub_sad_m.astype(np.int32)),
            "ok": _to(cuda, ok), "sub_ok": _to(cuda, sub_ok), "elig": _to(cuda, rng.random(nb) < 0.8),
            "qps": _to(cuda, rng.integers(0, 13, nb).astype(np.int32))}


def _select(fn, a, bs, vbs, qp, ft, with_ok):
    sad, sub_sad = (a["sad_masked"], a["sub_sad_masked"]) if with_ok else (a["sad"], a["sub_sad"])
    return fn(a["res"], a["quads"] if vbs else None, sad, sub_sad if vbs else None, ft, a["qps"],
              qp_nominal=qp, lam=0.015, vbs_enable=vbs, vbs_eligible=a["elig"], bs=bs, sbs=bs // 2,
              ok_full=a["ok"] if with_ok else None, ok_quads=a["sub_ok"] if with_ok and vbs else None)


@pytest.mark.parametrize("vbs", [False, True], ids=["full", "vbs"])
@pytest.mark.parametrize("bs", [4, 8, 16])
@pytest.mark.parametrize("qp", [0, 4, 11])
def test_transform_select_kernel_matches_plain(cuda, bs, vbs, qp):
    rng = np.random.default_rng(bs * 100 + qp * 2 + vbs)
    a = _select_case(cuda, rng, 300, bs)
    for ft in (0, 1):
        for with_ok in (False, True):
            n0 = K.transform_select.launches
            got = _select(K.transform_select, a, bs, vbs, qp, ft, with_ok)
            torch.cuda.synchronize()
            assert K.transform_select.launches == n0 + 1
            want = _select(K.transform_select_plain, a, bs, vbs, qp, ft, with_ok)
            for name, g, w in zip(("split", "qtc_full", "qtc_quads", "lens", "mae"), got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (name, ft, with_ok)


def _recon_case(cuda, rng, nbr, nbc, bs, dtype):
    nb, s = nbr * nbc, bs // 2
    qps = rng.integers(0, 13, nb)
    res = rng.integers(-255, 256, (nb, bs, bs))
    ch = _checkerboards(bs)
    res[: len(ch)], qps[: len(ch)] = ch, 0
    r = torch.from_numpy(res.astype(np.int32))
    qt = torch.from_numpy(qps.astype(np.int32))
    qf = Q.quantize(T.dct2_int(r), qt)
    qq = Q.quantize(T.dct2_int(r.reshape(nb, 2, s, 2, s).transpose(2, 3).reshape(nb, 4, s, s)), Q.qp_minus_1(qt)[:, None])
    h, w = nbr * bs, nbc * bs
    return {"qf": qf.to(dtype).to(cuda), "qq": qq.to(dtype).to(cuda), "qps": qt.to(cuda),
            "pred": _to(cuda, rng.integers(0, 256, (h, w)).astype(np.int16)),
            "pred_q": _to(cuda, rng.integers(0, 256, (h, w)).astype(np.int16)),
            "split": _to(cuda, rng.random(nb) < 0.5), "ok": _to(cuda, rng.random(nb) < 0.8),
            "sub_ok": _to(cuda, rng.random((nb, 4)) < 0.8)}


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("vbs", [False, True], ids=["full", "vbs"])
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_residual_recon_kernel_matches_plain(cuda, bs, vbs, dtype):
    rng = np.random.default_rng(bs * 10 + vbs)
    a = _recon_case(cuda, rng, 5, 7, bs, dtype)
    qq = a["qq"] if vbs else None
    n0 = K.residual_recon.launches
    got = K.residual_recon(a["qf"], qq, a["qps"])
    torch.cuda.synchronize()
    want = K.residual_recon_plain(a["qf"], qq, a["qps"])
    assert torch.equal(got[0], want[0]) and (got[1] is None if not vbs else torch.equal(got[1], want[1]))
    for with_ok in (False, True):
        args = (a["qf"], qq, a["qps"], a["pred"], a["pred_q"] if vbs else None, a["split"] if vbs else None,
                a["ok"] if with_ok else None, a["sub_ok"] if with_ok and vbs else None)
        got = K.residual_recon(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8 and torch.equal(got, K.residual_recon_plain(*args)), with_ok
    assert K.residual_recon.launches == n0 + 3


def _intra_frame(cuda, rng, kind, h, w):
    if kind == "noise":
        f = rng.integers(0, 256, (h, w))
    elif kind == "flat":
        f = np.full((h, w), 128)
    elif kind == "checker":
        f = np.where(np.indices((h, w)).sum(0) % 2, 255, 0)
    else:
        f = synthetic_clip(h, w, 1, seed=h)[0]
    return _to(cuda, f.astype(np.uint8))


def _intra_search_equal(cur, bs, sr, canvas, vbs, transpose):
    n0 = K.intra_search.launches
    got = K.intra_search(cur, bs, sr, canvas, vbs, transpose)
    torch.cuda.synchronize()
    assert K.intra_search.launches == n0 + 1
    want = K.intra_search_plain(cur, bs, sr, canvas, vbs, transpose)
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1])
    assert (got[2] is None and want[2] is None) or torch.equal(got[2], want[2])


@pytest.mark.parametrize("vbs", [False, True], ids=["full", "vbs"])
@pytest.mark.parametrize("bs,sr", [(bs, sr) for bs in (8, 16) for sr in (0, 1, 8, 16, 40)] + [(16, 127), (4, 3),
                                                                                               (6, 9), (12, 20),
                                                                                               (32, 16)])
def test_intra_search_kernel_matches_plain(cuda, bs, sr, vbs):
    """Both intra modes, the frame's canvas and a wider one, noise, flat
    (every shift ties), checkerboard and smooth frames."""
    rng = np.random.default_rng(bs * 1000 + sr + vbs)
    h, w = 3 * bs, 5 * bs
    for kind in ("noise", "flat", "checker", "smooth"):
        cur = _intra_frame(cuda, rng, kind, h, w)
        for transpose, extra in ((False, 0), (False, 40), (True, 0), (True, 17)):
            _intra_search_equal(cur, bs, sr, (h if transpose else w) + extra, vbs, transpose)


@pytest.mark.parametrize("transpose", [False, True], ids=["mode0", "mode1"])
def test_residual_coding_kernels_match_plain_at_720p(cuda, transpose):
    """The three kernels at 720p, sr = 16 with VBS, on a smooth frame: the
    search, then the select and the dequantization on its outputs."""
    cur = _to(cuda, synthetic_clip(720, 1280, 1, seed=7)[0])
    _intra_search_equal(cur, 16, 16, 720 if transpose else 1280, True, transpose)
    s, rf, rq = K.intra_search(cur, 16, 16, 720 if transpose else 1280, True, transpose)
    nb = rf.shape[0]
    qps = torch.full((nb,), 4, dtype=torch.int32, device=cuda)
    elig = torch.ones(nb, dtype=torch.bool, device=cuda)
    args = (rf, rq, s["sad"].reshape(-1), s["sub_sad"].reshape(nb, 4), 0, qps)
    kw = dict(qp_nominal=4, lam=0.015, vbs_enable=True, vbs_eligible=elig, bs=16, sbs=8)
    got, want = K.transform_select(*args, **kw), K.transform_select_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(K.residual_recon(got[1], got[2], qps), K.residual_recon_plain(got[1], got[2], qps)):
        assert torch.equal(g, w)


def test_residual_coding_wrappers_refuse_what_their_kernels_do_not_take(cuda):
    n0 = (K.transform_select.launches, K.residual_recon.launches, K.intra_search.launches)
    z = torch.zeros((6, 12, 12), dtype=torch.int32, device=cuda)
    zi = torch.zeros(6, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bs in"):
        K.transform_select(z, None, zi, None, 1, zi, qp_nominal=4, lam=None, vbs_enable=False, vbs_eligible=None,
                           bs=12, sbs=6)
    with pytest.raises(ValueError, match="bs in"):
        K.residual_recon(z, None, zi)
    z16 = torch.zeros((6, 16, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="nominal QP"):
        K.transform_select(z16, torch.zeros((6, 4, 8, 8), dtype=torch.int32, device=cuda), zi,
                           torch.zeros((6, 4), dtype=torch.int32, device=cuda), 1, zi, qp_nominal=4, lam=None,
                           vbs_enable=True, vbs_eligible=torch.ones(6, dtype=torch.bool, device=cuda), bs=16, sbs=8)
    with pytest.raises(TypeError, match="qtc_full"):
        K.residual_recon(z16.to(torch.int64), None, zi)
    frame = torch.zeros((32, 48), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="0 <= sr <= 127"):
        K.intra_search(frame, 16, 128, 48, True)
    with pytest.raises(ValueError, match="even under VBS"):
        K.intra_search(torch.zeros((30, 45), dtype=torch.uint8, device=cuda), 15, 4, 45, True)
    with pytest.raises(ValueError, match="contiguous"):
        K.intra_search(frame.T, 16, 8, 32, False)
    assert (K.transform_select.launches, K.residual_recon.launches, K.intra_search.launches) == n0


#: the plain functions the native frame steps ran before their kernels, by the modules that bind them
_STEP_PLAINS = {
    "transform": ("dct2_int", "idct2_int"), "quant": ("quantize", "rescale"), "zigzag": ("rle_length",),
    "rd": ("transform_and_select", "dct2_int", "quantize", "rle_length"),
    "intra": ("intra_search_mode0", "intra_residuals_mode0"), "kernels": ("idct2_int", "rescale"),
}

RESIDUAL_TOOLS = {
    "whole_pel": dict(search_range=8),
    "vbs_fme": dict(search_range=8, vbs_enable=True, fme_enable=True),
    "fast_vbs_fme_sr16": dict(search_range=16, fast_me=True, vbs_enable=True, fme_enable=True),
    "intra1_vbs_sr16": dict(search_range=16, intra_mode=1, vbs_enable=True),
    "roi_rc_vbs": dict(search_range=8, vbs_enable=True, rc_flag=1, target_br="60 kbps", frame_rate=30,
                       roi_qp_map=np.arange(24) % 5 - 2,
                       qp_rate_tables=[[9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180],
                                       [8000, 3500, 1800, 1000, 700, 500, 400, 300, 250, 210, 190, 170]]),
}


@pytest.mark.parametrize("name", list(RESIDUAL_TOOLS))
def test_residual_coding_on_card_never_calls_the_plain_functions(cuda, name, monkeypatch):
    """An encode and a decode on the card, with the eight plain functions the
    frame steps ran before (the int DCT pair, quantize, rescale,
    rle_length, transform_and_select, the intra search and residuals) and
    every ``*_plain`` patched to raise, equal the CPU port; each frame is one
    ``transform_select`` launch, each encoded and decoded frame one
    ``residual_recon``, each intra frame one ``intra_search``."""
    import importlib

    from streamoptima_tpu_torch.engine import frame_arrays_of

    cfg = CodecConfig(height=64, width=96, frames=7, qp=4, intra_dur=3, lam=0.015, **RESIDUAL_TOOLS[name])
    clip = synthetic_clip(64, 96, 7, seed=5)
    b = TorchCodec(cfg, clip, device="cpu").encode(package=False)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain function ran in a frame step on the card")

    for mod, names in _STEP_PLAINS.items():
        m = importlib.import_module(f"streamoptima_tpu_torch.core.{mod}")
        for attr in names:
            monkeypatch.setattr(m, attr, refuse)
    _refuse_plain(monkeypatch)
    codec = TorchCodec(cfg, clip, device=cuda)
    n0 = (K.transform_select.launches, K.residual_recon.launches, K.intra_search.launches)
    a = codec.encode(package=False)
    fts = a["frame_type_seq"]
    assert fts == b["frame_type_seq"] == [0, 1, 1, 0, 1, 1, 0]
    counts = (K.transform_select.launches - n0[0], K.residual_recon.launches - n0[1], K.intra_search.launches - n0[2])
    assert counts == (7, 7, 3)
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    assert a["Qp_per_row_per_frame"] == b["Qp_per_row_per_frame"]
    for fa, fb in zip(a["per_frame"], b["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "size", "row_bits", "mae"):
            assert torch.equal(fa[k].cpu(), fb[k]), k
    pairs = [frame_arrays_of(o, ft) for o, ft in zip(a["per_frame"], fts)]
    dec = codec.decode(fts, [r for _, r in pairs], a["Qp_per_row_per_frame"], [m for m, _ in pairs])
    assert K.residual_recon.launches - n0[1] == 14
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), b["reconstructed frames"])


def test_frame_spans_count_every_kernel_launch(cuda):
    """The tracer's ``engine.frame`` spans: their per-kernel launch counts
    sum, over an encode and its decode, to each wrapper's ``.launches``
    change, and the outputs are those of an untraced encode."""
    from collections import Counter

    from streamoptima_tpu_torch import profiling
    from streamoptima_tpu_torch.engine import frame_arrays_of
    from streamoptima_tpu_torch.profiling import tracer

    cfg = CodecConfig(height=64, width=96, frames=6, search_range=16, qp=4, intra_dur=4, lam=0.015,
                      vbs_enable=True, fme_enable=True, fast_me=True)
    clip = synthetic_clip(64, 96, 6, seed=3)
    b = TorchCodec(cfg, clip, device=cuda).encode(package=False)
    wrappers = profiling._launch_counters()
    before = {name: fn.launches for name, fn in wrappers}
    tracer.reset()
    tracer.enable()
    try:
        codec = TorchCodec(cfg, clip, device=cuda)
        a = codec.encode(package=False)
        fts = a["frame_type_seq"]
        pairs = [frame_arrays_of(o, ft) for o, ft in zip(a["per_frame"], fts)]
        dec = codec.decode(fts, [r for _, r in pairs], a["Qp_per_row_per_frame"], [m for m, _ in pairs])
        torch.cuda.synchronize()
    finally:
        tracer.disable()
    changed = {name: fn.launches - before[name] for name, fn in wrappers if fn.launches != before[name]}
    frames = [r[6] for r in tracer.records if r[0] == "engine.frame"]
    confirmed = tracer.snapshot()["confirm_blocks"]
    tracer.reset()
    assert len(frames) == 2 * cfg.frames
    summed = Counter()
    for attrs in frames:
        summed.update(attrs["launches"])
    assert dict(summed) == changed
    assert {"rowscan_pass", "window_fetch", "fast_confirm", "pred_fetch_fme_vbs", "transform_select",
            "residual_recon", "intra_search", "intra_recon"} <= set(changed)
    # every inter frame of the encode: one confirm, in one launch, every block on the kernel's route
    n_inter = fts.count(1)
    assert [f["launches"].get("fast_confirm", 0) for f in frames[:cfg.frames]] == fts
    assert changed["fast_confirm"] == n_inter and confirmed == {"kernel": cfg.n_blocks * n_inter}
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), b["reconstructed frames"])


# --------------------------------------------- the container's run-length coding (rle_pack)
def _rle_cols(pkg: dict) -> list:
    return [[o[k] for o in pkg["per_frame"]] for k in ("split", "mv", "sub_mv", "qtc_full", "qtc_quads")]


def _rle_equal(cols: list, cap: int) -> torch.Tensor:
    """The kernel's buffer against the plain version's on the same device tensors, exactly."""
    n0 = K.rle_pack.launches
    got = K.rle_pack(*cols, cap)
    torch.cuda.synchronize()
    assert K.rle_pack.launches == n0 + 2
    assert torch.equal(got, K.rle_pack_plain(*cols, cap))
    return got


@pytest.fixture(scope="module")
def segment_720p():
    """A 720p fast ME + VBS + FME segment of 16 frames, encoded on the card (package=False)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = CodecConfig(height=720, width=1280, frames=16, search_range=16, qp=4, intra_dur=8, lam=0.015,
                      vbs_enable=True, fme_enable=True, fast_me=True)
    from streamoptima_tpu_torch import VideoCodec

    codec = VideoCodec(cfg, synthetic_clip(720, 1280, 16, seed=18), device="cuda")
    pkg = codec.encode(compute_ssim=False, package=False)
    return cfg, codec, pkg


def test_rle_pack_kernel_matches_plain_on_a_720p_segment(cuda, segment_720p):
    cfg, _, pkg = segment_720p
    cols = _rle_cols(pkg)
    assert any(int(s.sum()) for s in cols[0]) and not all(bool(s.all()) for s in cols[0])
    got = _rle_equal(cols, sum(pkg["residual size per frame"])).cpu().numpy()
    totals = got[: 4 * cfg.frames].view(np.int32).reshape(-1, 2).sum(1)
    assert totals.tolist() == pkg["residual size per frame"]


@pytest.mark.parametrize("n,nb", [(16, 3600), (16, 70), (8, 130), (4, 67)])
def test_rle_pack_kernel_matches_plain_at_extremes(cuda, n, nb):
    """Zero, all-nonzero, alternating, +-4080 and random blocks, no, every and
    some blocks split, scalar and triple MVs, MVs outside int16, a capacity
    both exact and short (dropped symbols, bit 1)."""
    rng = np.random.default_rng(n * nb)
    s = n // 2
    from streamoptima_tpu_torch.core.zigzag import diag_scan_indices

    alt = np.zeros(n * n, np.int64)
    alt[diag_scan_indices(n)[::2]] = -3
    kinds = {"zero": lambda shape: np.zeros(shape, np.int64),
             "nonzero": lambda shape: rng.choice([-1, 1], shape) * rng.integers(1, 4081, shape),
             "alternating": lambda shape: (np.broadcast_to(alt.reshape(n, n), (shape[0], n, n)).reshape(-1)[
                 : int(np.prod(shape))].reshape(shape)),
             "extremes": lambda shape: rng.choice([-4080, 0, 4080], shape),
             "random": lambda shape: np.where(rng.random(shape) < rng.random(), rng.integers(-4080, 4081, shape), 0)}
    cols = [[] for _ in range(5)]
    for i, (kind, make) in enumerate(kinds.items()):
        split = [np.zeros(nb, bool), np.ones(nb, bool), rng.random(nb) < 0.5][i % 3]
        tail = () if i == 0 else (3,)
        mv = rng.integers(-40000, 40001, (nb,) + tail) if kind == "extremes" else rng.integers(-40, 41, (nb,) + tail)
        for c, a in enumerate((split, mv.astype(np.int32), rng.integers(-40, 41, (nb, 4) + tail).astype(np.int32),
                               make((nb, n, n)).astype(np.int16), make((nb, 4, s, s)).astype(np.int16))):
            cols[c].append(torch.from_numpy(np.ascontiguousarray(a)).to(cuda))
    plain = K.rle_pack_plain(*cols, 0)
    a, _ = K.rle_pack_layout(len(kinds), nb)
    cap = int(plain[: 4 * len(kinds)].view(torch.int32).sum())
    got = _rle_equal(cols, cap)
    assert int(got[4 * len(kinds): a].view(torch.int32)[0]) == 1  # the unsplit extremes frame's MVs pass int16
    short = _rle_equal(cols, cap - 7)
    assert int(short[4 * len(kinds): a].view(torch.int32)[0]) == 3
    assert torch.equal(short[a:], got[a: got.numel() - 7]) and torch.equal(short[: 4 * len(kinds)],
                                                                          got[: 4 * len(kinds)])


def test_rle_pack_wrapper_raises_instead_of_falling_back(cuda):
    nb = 6
    cols = [[torch.zeros(nb, dtype=torch.bool, device=cuda)], [torch.zeros((nb, 3), dtype=torch.int32, device=cuda)],
            [torch.zeros((nb, 4, 3), dtype=torch.int32, device=cuda)],
            [torch.zeros((nb, 16, 16), dtype=torch.int16, device=cuda)],
            [torch.zeros((nb, 4, 8, 8), dtype=torch.int16, device=cuda)]]
    K.rle_pack(*cols, nb)
    with pytest.raises(TypeError):
        K.rle_pack(*cols[:3], [cols[3][0].to(torch.int32)], cols[4], nb)
    with pytest.raises(ValueError):  # one frame's tensors on two devices
        K.rle_pack(*cols[:4], [cols[4][0].cpu()], nb)
    with pytest.raises(ValueError):  # a block size the kernel does not take
        K.rle_pack(*cols[:3], [torch.zeros((nb, 6, 6), dtype=torch.int16, device=cuda)],
                   [torch.zeros((nb, 4, 3, 3), dtype=torch.int16, device=cuda)], nb)


def test_container_write_codes_on_the_card_in_one_copy(cuda, segment_720p, tmp_path):
    """One ``transmit_bitstream_binary`` of a ``package=False`` encode: two
    ``rle_pack`` launches, every frame coded on the card, one device-to-host
    copy; the file equals the host route's (the list package's)."""
    from streamoptima_tpu_torch import VideoCodec
    from streamoptima_tpu_torch.profiling import tracer

    cfg, codec, pkg = segment_720p
    n0 = K.rle_pack.launches
    tracer.reset()
    tracer.enable()
    try:
        codec.transmit_bitstream_binary(tmp_path / "card.sob")
    finally:
        tracer.disable()
    snap = tracer.snapshot()
    tracer.reset()
    assert K.rle_pack.launches == n0 + 2
    assert snap["rle_frames"] == {"device": cfg.frames}
    assert snap["host_syncs"] == {"fetch": 1} and snap["host_syncs"]["fetch"] <= 2
    _, s0 = K.rle_pack_layout(cfg.frames, cfg.n_blocks)
    assert snap["d2h_bytes"]["fetch"] == 2 * (s0 + sum(pkg["residual size per frame"]))
    host = VideoCodec(cfg, synthetic_clip(720, 1280, 16, seed=18), device=cuda)
    host.encode(compute_ssim=False)
    host.transmit_bitstream_binary(tmp_path / "host.sob")
    assert K.rle_pack.launches == n0 + 2
    assert (tmp_path / "card.sob").read_bytes() == (tmp_path / "host.sob").read_bytes()
    dec = VideoCodec(cfg, device=cuda).decode_bitstream_binary(tmp_path / "card.sob")
    np.testing.assert_array_equal(dec, pkg["reconstructed frames"])


# --------------------------------------------- the container's run-length decoding (rle_unpack)
def _unpack_buffer(cfg, res, mvs, cuda):
    """The decoders' device buffer of a read container (``pack_stream``'s
    coded payload, laid out and copied as ``upload_stream`` does), and the
    host route's payload of the same frames."""
    from streamoptima_tpu_torch.bitstream import FrameResArrays
    from streamoptima_tpu_torch.engine import CodedPayload, pack_stream

    fts = [m.ftype for m in mvs]
    pay = pack_stream(cfg, fts, res, mvs)[3]
    assert isinstance(pay, CodedPayload)
    host = np.zeros(pay.nbytes, np.uint8)
    pay.fill(host)
    dense = pack_stream(cfg, fts, [FrameResArrays(r.split, r.qf, r.qq) for r in res], mvs)[3]
    return torch.from_numpy(host).to(cuda), pay, dense


def _unpack_equal(buf, frames: int, nb: int, bs: int) -> torch.Tensor:
    """The kernel's payload against the plain version's on the same device buffer, exactly."""
    n0 = K.rle_unpack.launches
    got = K.rle_unpack(buf, frames, nb, bs)
    torch.cuda.synchronize()
    assert K.rle_unpack.launches == n0 + 1
    assert torch.equal(got, K.rle_unpack_plain(buf, frames, nb, bs))
    return got


@pytest.fixture(scope="module")
def segment_1088p_nref4():
    """A 1088p half-pel full search + VBS encode over four references, 8 frames, its container read back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import tempfile
    from pathlib import Path

    from streamoptima_tpu_torch import VideoCodec, binstream

    cfg = CodecConfig(height=1088, width=1920, frames=8, search_range=16, qp=4, intra_dur=8, lam=0.015,
                      vbs_enable=True, fme_enable=True, fast_me=False, n_ref_frames=4)
    codec = VideoCodec(cfg, synthetic_clip(1088, 1920, 8, seed=19), device="cuda")
    pkg = codec.encode(compute_ssim=False, package=False)
    with tempfile.TemporaryDirectory() as d:
        codec.transmit_bitstream_binary(Path(d) / "b.sob")
        return cfg, pkg, binstream.read_binary(Path(d) / "b.sob", cfg)


@pytest.mark.parametrize("shape", ["720p", "1088p-nref4"])
def test_rle_unpack_kernel_matches_plain_on_a_container(cuda, shape, request, tmp_path):
    """The decode cell's container (720p, 16 frames, fast ME + VBS + FME)
    and a 1088p one over four references: kernel == plain == the host
    route's payload, and the decode of its payload is the reconstruction."""
    from streamoptima_tpu_torch import binstream

    if shape == "720p":
        cfg, codec, pkg = request.getfixturevalue("segment_720p")
        codec.transmit_bitstream_binary(tmp_path / "c.sob")
        fts, mvs, qps, res = binstream.read_binary(tmp_path / "c.sob", cfg)
    else:
        cfg, pkg, (fts, mvs, qps, res) = request.getfixturevalue("segment_1088p_nref4")
    assert any(int(m.split.sum()) for m in mvs) and not all(bool(m.split.all()) for m in mvs)
    buf, _, dense = _unpack_buffer(cfg, res, mvs, cuda)
    got = _unpack_equal(buf, cfg.frames, cfg.n_blocks, cfg.block_size)
    np.testing.assert_array_equal(got.cpu().numpy(), dense)
    dec = TorchCodec(cfg, device=cuda).decode(fts, res, qps, mvs)
    np.testing.assert_array_equal(torch.stack(dec).cpu().numpy(), pkg["reconstructed frames"])


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_rle_unpack_kernel_matches_plain_and_native_on_adversarial_lists(cuda, bs):
    """Random symbol lists, not an encoder's: headers -1 to -(m + 5) and
    -32768, zero runs of 1 to m + 5 and 32767, early 0s, values of either
    sign, lists of 0 to 2m + 40 symbols, some past the unit's end and some
    short of their runs; no, every and some blocks split, each frame's
    fields at another file offset.  Kernel == plain == ``native``."""
    from streamoptima_tpu_torch import binstream, native
    from streamoptima_tpu_torch.bitstream import FrameMVArrays

    rng = np.random.default_rng(bs)
    cfg = CodecConfig(height=8 * bs, width=12 * bs, frames=3, block_size=bs, search_range=4, qp=4, intra_dur=3,
                      vbs_enable=True)
    nb, s = cfg.n_blocks, bs // 2

    def unit(m):
        out = []
        for _ in range(int(rng.integers(0, 2 * m + 41))):
            r = rng.random()
            out.append(int(-rng.integers(1, m + 6) if r < 0.25 else rng.integers(1, m + 6) if r < 0.35 else
                           -32768 if r < 0.37 else 32767 if r < 0.39 else 0 if r < 0.41 else
                           rng.integers(-4080, 4081)))
        return out

    res = []
    for f, split in enumerate([np.zeros(nb, bool), np.ones(nb, bool), rng.random(nb) < 0.4]):
        fields = []
        for lists in ([unit(bs * bs) for _ in range(int((~split).sum()))],
                      [unit(s * s) for _ in range(4 * int(split.sum()))]):
            offs = np.zeros(len(lists) + 1, "<u4")
            np.cumsum([len(x) for x in lists], out=offs[1:])
            fields += [offs, np.asarray([v for x in lists for v in x], "<i2")]
        data = b"\x01" * (2 * f + 1) + b"".join(a.tobytes() for a in fields)
        at = np.cumsum([2 * f + 1] + [a.nbytes for a in fields[:3]])
        view = [np.frombuffer(data, a.dtype, len(a), int(o)) for a, o in zip(fields, at)]
        res.append(binstream.CodedResiduals(split, data, (2 * f + 1, len(data)), view[0].astype(np.int64), view[1],
                                            view[2].astype(np.int64), view[3], bs))
    mvs = [FrameMVArrays(0, np.zeros((nb, 3), np.int32), r.split, np.zeros((nb, 4, 3), np.int32)) for r in res]
    buf, _, dense = _unpack_buffer(cfg, res, mvs, cuda)
    got = _unpack_equal(buf, 3, nb, bs).cpu().numpy()
    np.testing.assert_array_equal(got, dense)
    for r, pay in zip(res, got):
        if (~r.split).any():
            np.testing.assert_array_equal(pay[~r.split], native.rle_decode_blocks(r.vals_f, r.offs_f, bs))


def test_binary_decode_decodes_on_the_card_in_one_launch(cuda, segment_720p, tmp_path):
    """``decode_bitstream_binary`` of the decode cell's container: one
    ``rle_unpack`` launch, every frame decoded on the card, no host RLE, the
    container's one copy pinned; the traced two-step call (``read_binary``,
    then ``VideoCodec.decode``, as the benchmark's traced decode calls it)
    takes the same route.  Both decodes are the reconstructions."""
    from streamoptima_tpu_torch import VideoCodec, binstream
    from streamoptima_tpu_torch.profiling import tracer

    cfg, codec, pkg = segment_720p
    codec.transmit_bitstream_binary(tmp_path / "c.sob")
    dec = VideoCodec(cfg, device=cuda)
    dec.decode_bitstream_binary(tmp_path / "c.sob")  # the stage's first use
    snaps, launches = [], []
    for two_step in (False, True):
        n0 = K.rle_unpack.launches
        tracer.reset()
        tracer.enable()
        try:
            if two_step:
                fts, mvs, qps, res = binstream.read_binary(tmp_path / "c.sob", dec.cfg)
                frames = dec.decode(fts, res, qps, mvs)
            else:
                frames = dec.decode_bitstream_binary(tmp_path / "c.sob")
        finally:
            tracer.disable()
        snaps.append(tracer.snapshot())
        launches.append(K.rle_unpack.launches - n0)
        np.testing.assert_array_equal(frames, pkg["reconstructed frames"])
    tracer.reset()
    for snap in snaps:
        assert snap["rle_decoded_frames"] == {"device": cfg.frames}
        assert "binstream.rle_decode" not in snap["spans"]
        stream = snap["h2d_bytes"]["stream"]
        assert set(snap["h2d_bytes"]) == {"stream", "container"}
        assert snap["pageable_bytes"]["h2d"] == stream  # the container's copy is pinned
    assert launches == [1, 1] and snaps[0]["h2d_bytes"] == snaps[1]["h2d_bytes"]


# ------------------- the half-pel full search at class B size, four references
H_B, W_B = 1088, 1920


def _moving_1088p(cuda, nref: int, content: str, seed: int):
    """cur and ``nref`` references at 1088x1920: random pixels, or a smoothed
    texture that reference r holds, in its own band of columns only (random
    pixels elsewhere), shifted by (nref - r) * (3, -2) px, so the winners
    lie inside the range and on every reference."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 256, (nref, H_B, W_B), dtype=np.uint8)
    if content == "random":
        cur = rng.integers(0, 256, (H_B, W_B), dtype=np.uint8)
    else:
        clip = synthetic_clip(H_B + 64, W_B + 64, 1, seed=seed)[0]
        cur = clip[32:32 + H_B, 32:32 + W_B]
        band = W_B // nref
        for r in range(nref):
            k = nref - r
            shifted = clip[32 - 2 * k:32 - 2 * k + H_B, 32 + 3 * k:32 + 3 * k + W_B]
            refs[r, :, r * band:(r + 1) * band] = shifted[:, r * band:(r + 1) * band]
    return torch.from_numpy(np.ascontiguousarray(cur)).to(cuda), torch.from_numpy(refs).to(cuda)


@pytest.mark.parametrize("content", ["moving", "random"])
@pytest.mark.parametrize("nref", [1, 2, 3, 4])
def test_fme_vbs_search_kernel_matches_plain_at_1088p(cuda, nref, content):
    """Kernel 2's VBS instance at the ``full-vbs-fme-nref4-1088p`` shape:
    68 x 120 blocks, sr 16 (the +-32 half-pel fields of the tie-break key,
    48 x 48 windows), the parity planes of one to four references staged
    in turns; MVs, SADs, ok and the quads' equal the plain version's."""
    cur, refs = _moving_1088p(cuda, nref, content, 1088 + nref)
    planes = M.fme_parity_planes(refs, True)
    n0 = K.full_search_fme_vbs.launches
    got = K.full_search_fme_vbs(cur, planes, 16, 16)
    torch.cuda.synchronize()
    assert K.full_search_fme_vbs.launches == n0 + 1
    want = K.full_search_fme_vbs_plain(cur, planes, 16, 16)
    _fme_search_equal(got, want)
    if content == "moving":  # every reference wins somewhere
        assert set(got["mv"][:, 2].unique().tolist()) == set(range(nref))
    del want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("bound", [32, 5000])
def test_fme_quad_fetch_kernel_matches_plain_at_1088p(cuda, bound):
    """``pred_fetch``'s FME instance with the quad plane at 1088 x 1920 over
    four references: MVs and quad MVs at every reference index 0 to 3, in
    the search's range and far past the frame."""
    rng = np.random.default_rng(bound + 4)
    nb = (H_B // 16) * (W_B // 16)
    refs = torch.from_numpy(rng.integers(0, 256, (4, H_B, W_B), dtype=np.uint8)).to(cuda)
    planes = M.fme_parity_planes(refs, True)
    mv = np.stack([rng.integers(-bound, bound + 1, nb), rng.integers(-bound, bound + 1, nb),
                   np.arange(nb) % 4], 1).astype(np.int32)
    smv = np.stack([rng.integers(-bound, bound + 1, (nb, 4)), rng.integers(-bound, bound + 1, (nb, 4)),
                    rng.integers(0, 4, (nb, 4))], 2).astype(np.int32)
    mv, smv = torch.from_numpy(mv).to(cuda), torch.from_numpy(smv).to(cuda)
    n0 = K.pred_fetch_fme_vbs.launches
    got = K.pred_fetch_fme_vbs(mv, smv, planes, 16)
    torch.cuda.synchronize()
    assert K.pred_fetch_fme_vbs.launches == n0 + 1
    plain = K.pred_fetch_fme_vbs_plain(mv, smv, planes, 16)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
