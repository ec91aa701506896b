"""The scaling harness (bench.py --config scaling) runs on the virtual CPU
mesh and its collective schedule stays flat as the mesh grows (BASELINE.json
north-star scaling artifact)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.timeout(900)
def test_scaling_harness_runs_and_collectives_stay_flat():
    import bench

    result = bench.bench_scaling(iters=3, repeats=1, device_counts=[1, 2, 4],
                                 hr=32, frames=4)
    points = result["points"]
    assert [p["devices"] for p in points] == [1, 2, 4]
    for p in points:
        assert p["frame_iters_per_s"] > 0
    # The contract: the per-evaluation collective schedule (reductions
    # inside the CG while_loop body) does not grow with the mesh — N devices
    # reduce the same scalar cost + one gradient image. One device has none.
    ars = [p["all_reduce"] for p in points[1:]]
    cps = [p["collective_permute"] for p in points[1:]]
    assert points[0]["all_reduce"] == 0 and ars[0] > 0
    assert len(set(ars)) == 1, ars
    assert len(set(cps)) == 1, cps
