"""Host milliseconds a call spends before the model starts: from the
benchmark's span around the call to the start of the model's root region
(letterbox, resize and normalisation in ``Predictor``), mean over the traced
calls."""


def read(run):
    calls = run.trace.spans("portbench_call")
    models = sorted(e["ts"] for e in run.trace.spans("model"))
    lead = []
    for c in calls:
        start = next((t for t in models if c["ts"] <= t <= c["ts"] + c["dur"]), None)
        if start is not None:
            lead.append((start - c["ts"]) * 1e-3)
    return sum(lead) / len(lead) if lead else None
