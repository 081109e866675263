"""Device milliseconds per image under the transformer (encoder, neck,
decoder, heads) and the post-processing."""


def read(run):
    images = run.traced.get("images")
    return 1e3 * run.trace.region_s("transformer", "post_process") / images if images else None
