"""The whole forward's share of the card's dense bfloat16 peak: the
reference's FLOPs per image on each canvas (counted on the reference, stored
in the configuration's file) times the images served on it in the window,
over the window's seconds and 989 TFLOP/s, in percent."""


def read(run):
    per = run.flops.get("serve", {})
    done = run.result.get("images_by_canvas", {})
    if not done or any(c not in per for c in done):
        return None
    flops = sum(per[c] * n for c, n in done.items())
    return 100.0 * flops / run.result["window_s"] / run.peaks["bf16_dense_flops_per_s"]
