"""Host-side shared-memory budget of the FME search (no card needed).

The wrapper refuses a shape whose block and four plane windows do not fit a
block's shared memory as bytes; the kernel takes every shape inside that
budget, staging a reference's four windows at a time where they fit and one
plane's at a time where they do not.  ``tests/test_torch_gpu.py`` runs the
largest blocks of this budget on the card, and holds ``rowscan_pass``'s
budget, which lives in its CUDA source, there.
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
