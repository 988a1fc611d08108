"""Device ms a solve of every operation that is not a PDIPM kernel: QP assembly,
postprocess and the wrapper's copies."""

from benchmark.layers import device_ms, is_pdipm


def read(trace):
    return device_ms(trace, lambda n: not is_pdipm(n))
