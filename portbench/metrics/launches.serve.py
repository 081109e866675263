"""Kernel launches that ran on the device in the traced window, per call."""


def read(run):
    n = run.traced.get("calls")
    return run.trace.kernels() / n if n else None
