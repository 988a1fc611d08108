"""Device ms a closed-loop cycle of every operation outside the PDIPM kernel: the
observation's IK, the ticks, QP assembly and the plant."""

from benchmark.layers import device_ms, is_pdipm


def read(trace):
    return device_ms(trace, lambda n: not is_pdipm(n))
