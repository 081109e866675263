"""Share of the traced window in which no kernel, copy or set ran on any
stream: 1 - (union of the device intervals) / window, in percent."""


def read(run):
    tr = run.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.window_s > 0 else None
