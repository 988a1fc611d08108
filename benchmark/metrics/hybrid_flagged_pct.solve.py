"""Flagged envs (over the flag tolerance or non-finite) as a share of the
batch, the mean over the window's solves of the program's own counter
(`MPCController.hybrid_counts`, summed on the device by the loop). None
where the loop read no counters."""


def read(trace):
    hybrid = trace.info.get("hybrid")
    if not hybrid or not trace.info.get("batch"):
        return None
    return 100.0 * hybrid["flagged"] / trace.info["batch"]
