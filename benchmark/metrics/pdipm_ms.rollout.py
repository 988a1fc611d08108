"""Device ms of the PDIPM kernels a closed-loop MPC cycle."""

from benchmark.layers import device_ms, is_pdipm


def read(trace):
    return device_ms(trace, is_pdipm)
