"""The least time a kernel call could take on one H100, from its shapes.

Each kernel has a module here named as in its metric (``<kernel>_roofline``)
with ``KERNEL`` (a part of its device name as the profiler records it),
``COUNTER`` (the module and function of the program whose ``launches``
attribute counts its calls) and ``cost(geometry) -> (operations, bytes)``
for one call: inputs read once, outputs written once, each multiply-add
two operations.  The peaks are NVIDIA's data sheet's for the H100 SXM at
its 700 W limit, dense."""

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def bound_s(ops: float, nbytes: float) -> float:
    """Seconds at the peaks: the larger of operations over the int8 tensor
    cores' rate and bytes over the memory's."""
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
