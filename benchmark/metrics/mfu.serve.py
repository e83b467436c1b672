"""The served calls' share of the card's bf16 peak: the network's FLOPs an
image from shapes (every conv tap, 2 a multiply-add; the decode's
arithmetic is not counted) times the images of the window, over the
window's seconds, in % of 989 TFLOP/s."""

from harness import cost


def read(run):
    if run.device.type != "cuda":
        return None
    rate = run.flops_per_image() * run.images / run.window_s
    return 100.0 * rate / cost.BF16_FLOPS
