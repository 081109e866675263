"""Device milliseconds per image under the RepVGG neck
(``transformer/repnet_neck``), forward and backward."""


def read(run):
    images = run.traced.get("images")
    return 1e3 * run.trace.region_s("transformer/repnet_neck") / images if images else None
