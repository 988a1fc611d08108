"""Device ms of the PDIPM kernels a solve (the batch's one run_mpc)."""

from benchmark.layers import device_ms, is_pdipm


def read(trace):
    return device_ms(trace, is_pdipm)
