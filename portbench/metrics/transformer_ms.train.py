"""Device milliseconds per image under the transformer and the contrastive
denoising queries, forward and backward."""


def read(run):
    images = run.traced.get("images")
    return 1e3 * run.trace.region_s("transformer", "denoising_generator") / images if images else None
