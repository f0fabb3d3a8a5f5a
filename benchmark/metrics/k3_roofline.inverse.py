"""K3's share of its roofline in the inverse step (csrc/nee_grad_kernel.cu,
replay): the least time of its segments at 1,211.6 operations a segment and
67 TFLOP/s, over K3's device time in the window."""

from benchmark.counts import ops
from benchmark.layers import roofline


def read(trace, work):
    return roofline(trace, "k3", work.get("k3_segments"), ops.OPS_PER_SEGMENT["nee_replay"])
