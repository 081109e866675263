"""Device milliseconds per step under the set criterion (matching and
losses) and the salience criterion, forward and backward."""


def read(run):
    steps = run.traced.get("steps")
    return 1e3 * run.trace.region_s("criterion", "salience_criterion") / steps if steps else None
