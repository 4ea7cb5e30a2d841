"""The index check of a host batch (``ops.batch_check``), which ``to_torch``
runs on the device after the copy.

On the CPU: the plain version at a tiny batch's sizes (a halo plan, ragged
tails, sorted arrays across the kernel's tile) passes the clean arrays and
gives each fault case of ``chip_smoke.batch_check_faults`` its word: values
outside the bound at the first and last element and at a tile's end, int64
values an int32 cast would wrap into range, and single descents of each
sorted array at its ends and across a warp, a pass, a block and into its
ragged tail. On a card (tests marked ``card``, which skip without one): the
kernel gives the plain version's word on every case, at the tiny sizes and
at one screen batch's (N 16,384, E 751,104, T 7,205,888), and reads those
92.5 MB at no less than half of the card's bandwidth. ``chip_smoke.py`` runs
the same checks in its phase 3. No JAX here.
"""

import pytest
import torch

import chip_smoke
from torch_m3gnet_tpu_torch.ops import batch_check as bc


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_plain_version_gives_each_fault_its_word():
    assert chip_smoke.check_batch_index(chip_smoke.BATCH_CHECK_SIZES["tiny"], "cpu")["cases"] == 51


def test_refuses_an_index_that_is_not_an_integer():
    rule = bc.IndexRule("edge_src", torch.zeros(4), 4, True, "a node index")
    with pytest.raises(TypeError, match="edge_src must hold integers"):
        bc.check_indices([rule])


@pytest.mark.card
@pytest.mark.parametrize("size", list(chip_smoke.BATCH_CHECK_SIZES))
def test_kernel_gives_the_plain_versions_word(size):
    card()
    chip_smoke.check_batch_index(chip_smoke.BATCH_CHECK_SIZES[size], "cuda")


@pytest.mark.card
def test_kernel_at_half_its_bound_or_better():
    card()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda").zero_()  # 256 MB > L2
    row = chip_smoke.time_batch_check(torch.cuda.get_device_name(0), flush)
    assert row["share"] >= chip_smoke.CHECK_MIN_SHARE
