"""Host-side shared-memory budgets of the search wrappers (no card needed).

The FME search's wrapper refuses a shape whose block and four plane windows
do not fit a block's shared memory as bytes; the kernel takes every shape
inside that budget, staging a reference's four windows at a time where they
fit and one plane's at a time where they do not.  The whole-pel searches'
wrappers keep their budgets, the block as int32 (``full_search``) or as
bytes (``full_search_vbs``) beside its (bs + 2sr)^2 window; the kernel takes
every shape inside them.  ``tests/test_torch_gpu.py`` runs the largest
blocks of these budgets on the card (the whole-pel searches' at every
range), and holds ``rowscan_pass``'s budget, which lives in its CUDA
source, there.
"""
import pytest
import torch

from streamoptima_tpu_torch.core import kernels as K


@pytest.mark.parametrize("sr,bs,want", [(8, 16, 256 + 4 * (32 * 32 + 4)), (16, 16, 256 + 4 * (48 * 48 + 4)),
                                        (4, 6, 36 + 4 * (14 * 14 + 4))])
def test_fme_search_shared_memory(sr, bs, want):
    assert K._fme_smem(sr, bs) == want <= K._SMEM_LIMIT


@pytest.mark.parametrize("sr,bs", [(1, 214), (4, 208), (16, 188), (63, 108)])
def test_fme_search_budget_takes_the_largest_even_blocks(sr, bs):
    """The largest even block size at each range: inside the budget, and the
    next even one outside it (the card runs (4, 208) and (16, 188))."""
    assert K._fme_smem(sr, bs) <= K._SMEM_LIMIT < K._fme_smem(sr, bs + 2)


def test_fme_search_refuses_what_does_not_fit():
    cur = torch.zeros((128, 128), dtype=torch.uint8)
    planes = torch.zeros((1, 4, 128, 128), dtype=torch.uint8)
    assert K._fme_smem(63, 128) > K._SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        K._launch_search("full_search_fme", cur, planes, 63, 128, False, K._fme_smem(63, 128), (0, 0, 128))


#: the largest block size each whole-pel search wrapper takes at each range under its budget,
#: 4 bs^2 + (bs + 2sr)^2 (full_search) or bs^2 + (bs + 2sr)^2 with bs even (full_search_vbs) <= 232448 bytes
LARGEST_WHOLE_PEL = {False: {1: 215, 8: 212, 16: 208, 63: 184, 127: 139},
                     True: {1: 338, 8: 332, 16: 324, 63: 272, 127: 188}}


@pytest.mark.parametrize("vbs", [False, True], ids=["full_search", "full_search_vbs"])
@pytest.mark.parametrize("sr", [1, 8, 16, 63, 127])
def test_whole_pel_search_budget_takes_the_same_largest_blocks(vbs, sr):
    """At each range the largest block the wrapper takes lies inside its
    budget and the next one (the next even one under VBS) outside, the
    budget being the wrappers' byte expression, so no shape they took is
    refused and none they refused is taken."""
    bs, step = LARGEST_WHOLE_PEL[vbs][sr], 2 if vbs else 1
    for b in (bs, bs + step):
        assert K._search_smem(sr, b, vbs) == b * b * (1 if vbs else 4) + (b + 2 * sr) ** 2
    assert K._search_smem(sr, bs, vbs) <= K._SMEM_LIMIT < K._search_smem(sr, bs + step, vbs)
    K._check_smem(bs, sr, K._search_smem(sr, bs, vbs))
    with pytest.raises(ValueError, match="shared memory"):
        K._check_smem(bs + step, sr, K._search_smem(sr, bs + step, vbs))


def test_whole_pel_vbs_search_refuses_what_does_not_fit():
    sr, bs = 8, 334
    cur = torch.zeros((bs, bs), dtype=torch.uint8)
    refs = torch.zeros((1, bs, bs), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shared memory"):
        K._launch_search("full_search_vbs", cur, refs, sr, bs, True, K._search_smem(sr, bs, True), (0, 0, bs))
