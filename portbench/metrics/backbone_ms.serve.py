"""Device milliseconds per image under the backbone and channel-mapper regions."""


def read(run):
    images = run.traced.get("images")
    return 1e3 * run.trace.region_s("backbone", "channel_mapper") / images if images else None
