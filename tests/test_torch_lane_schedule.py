"""The schedule of the forward kernel (K1) and the product-chain gradient
kernel (K2, K5): pure index arithmetic, held here on the CPU.

The kernels spread a pixel's samples over L sample lanes of one warp and
apply them to the pixel's sums (K1) and accumulators (K2) in sample order,
which keeps every output bit of the thread-a-pixel kernels. The wrappers
expose the schedule as Python functions that mirror the kernels' index
arithmetic (``trace_kernel.sample_lanes``, ``lane_schedule``, ``add_order``,
``sphere_table_banks``; ``grad_kernel.dump_store_plan``); these tests read
them.
"""

import numpy as np
import pytest

from pathtrace_tpu_torch.config import MAX_BLOCK
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import trace_kernel as tk

SPPS = (1, 2, 3, 5, 8, 16, 32)
BLOCKS = tuple(range(1, MAX_BLOCK + 1))
H100_SMS = 132


def lanes_of(spp, block, max_lanes=tk.MAX_LANES):
    """The lanes of a frame that leaves the card short of warps (lanes
    spread its samples), as the wrappers choose them on an H100."""
    return tk.sample_lanes(spp, block, 256 * 256, H100_SMS, max_lanes)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("spp", SPPS)
def test_every_pixel_sample_traced_once(spp, block):
    """A ragged 123x61 frame: every (pixel, sample) exactly once."""
    w, h = 123, 61
    s = tk.lane_schedule(w, h, block, spp, lanes_of(spp, block))
    assert len(s["sample"]) == w * h * spp
    key = (s["row"] * w + s["col"]) * spp + s["sample"]
    assert np.array_equal(np.sort(key), np.arange(w * h * spp))
    assert s["row"].max() == h - 1 and s["col"].max() == w - 1


@pytest.mark.parametrize("spp", SPPS)
def test_adds_come_in_sample_order(spp):
    """Each pixel's samples, taken round by round and lane by lane as the
    kernels apply them (K1's channel adds, K2's accumulator turns), come in
    sample order 0 .. spp - 1."""
    for block, lanes in ((1, 4), (5, 2), (8, 4), (8, 2), (8, 1), (16, 1)):
        lanes = min(lanes, lanes_of(spp, block))
        assert tk.add_order(spp, lanes) == list(range(spp))
        s = tk.lane_schedule(12, 7, block, spp, lanes)
        pixel = s["row"] * 12 + s["col"]
        order = np.lexsort((s["lane"], s["round"], pixel))  # by pixel, then turn
        samples = s["sample"][order].reshape(12 * 7, spp)
        assert np.array_equal(samples, np.tile(np.arange(spp), (12 * 7, 1)))
        # The lanes of a pixel are neighbouring threads of one warp.
        assert np.all(s["thread"] // 32 == (s["thread"] - s["lane"]) // 32)


@pytest.mark.parametrize("block", BLOCKS)
def test_threads_of_a_block_within_bounds(block):
    for spp in (*SPPS, 4, 64, 1000):
        for max_lanes in (gk.MAX_LANES, tk.MAX_LANES):
            lanes = lanes_of(spp, block, max_lanes)
            assert lanes in (1, 2, 4) and lanes <= min(spp, max_lanes)
            assert block * block * lanes <= tk.MAX_THREADS <= 1024
            assert 32 % lanes == 0
    assert lanes_of(1, block) == 1


def test_lanes_only_where_a_thread_a_pixel_leaves_the_card_short():
    """A 512x512 frame gives an H100's 132 SMs 1,986 threads each at one
    thread a pixel: one lane. A 256x256 frame gives 496: four lanes in K1,
    two in K2, at the main path's 8 and 16 spp."""
    for spp in (4, 8, 16, 32):
        assert tk.sample_lanes(spp, 8, 512 * 512, H100_SMS) == 1
        assert tk.sample_lanes(spp, 8, 256 * 256, H100_SMS) == 4
        assert tk.sample_lanes(spp, 8, 256 * 256, H100_SMS, gk.MAX_LANES) == 2
    assert tk.sample_lanes(16, 16, 256 * 256, H100_SMS) == 1  # 256 threads already
    assert tk.sample_lanes(2, 8, 128 * 64, H100_SMS) == 2


@pytest.mark.parametrize("lanes", (1, 2, 4))
def test_each_channel_stored_by_one_lane(lanes):
    for n_ch in tk.MODES.values():
        stores = [tk.store_lane(c, lanes) for c in range(n_ch)]
        assert all(0 <= j < lanes for j in stores)
        assert sorted(set(stores)) == list(range(min(lanes, n_ch)))


@pytest.mark.parametrize("block", (1, 5, 8, 16))
@pytest.mark.parametrize("num_spheres", (1, 9, 16))
def test_dump_stores_are_the_layout_offsets(block, num_spheres):
    """The dump's stores write each float of [h, W, 6N] once, at the offset
    of its (row, col, k), from the pixel's accumulator k in shared memory;
    the lanes of a pixel split its row, and a warp's first store covers
    whole runs of neighbouring floats."""
    w, h, n6 = 123, 61, 6 * num_spheres
    lanes = lanes_of(8, block, gk.MAX_LANES)
    plan = gk.dump_store_plan(w, h, block, num_spheres, lanes)
    assert np.array_equal(plan["address"], (plan["row"] * w + plan["col"]) * n6 + plan["k"])
    assert np.array_equal(np.sort(plan["address"]), np.arange(h * w * n6))
    assert np.array_equal(plan["k"] % lanes, plan["lane"])
    q = (plan["row"] % block) * block + plan["col"] % block
    assert np.array_equal(plan["shared"], plan["k"] * block * block + q)
    assert np.array_equal(plan["thread"], q * lanes + plan["lane"])
    first = plan["k"] < lanes  # each lane's first store: the pixel's lanes write k = 0..L-1
    assert np.array_equal(plan["address"][first] % n6, plan["lane"][first])


@pytest.mark.parametrize("num_spheres", range(1, tk.MAX_SPHERES + 1))
def test_sphere_table_fields_in_distinct_banks(num_spheres):
    """Any per-lane sphere index reads one field of the shared table in one
    wavefront: the field's words of the N <= 16 rows lie in distinct banks."""
    for field in range(tk.SPHERE_ROW_WORDS):
        banks = tk.sphere_table_banks(num_spheres, field)
        assert len(set(banks.tolist())) == num_spheres
