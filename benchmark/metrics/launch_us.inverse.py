"""The host's us a launch of K1 (NEE colour) and K3 (replay) in the inverse
step: the time inside the wrappers' ``launch`` (operands staged, the ctypes
call) over their launches."""

from benchmark.spans import launch_us


def read(trace, work):
    return launch_us(trace, ("k1", "k3.replay"))
