"""Device milliseconds a frame of every kernel that is not one of the
port's hand-written kernels: the CNN (cuDNN), its preprocessing and the
fade. Copies are left out."""

from benchmark.layers import NOT_KERNELS, is_port_kernel


def read(trace, work):
    if not work.get("units"):
        return None
    seconds = trace.time_of(lambda k: not is_port_kernel(k) and not k.startswith(NOT_KERNELS))
    return 1e3 * seconds / work["units"] if seconds > 0 else None
