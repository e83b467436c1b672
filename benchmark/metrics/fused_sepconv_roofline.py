"""`fused_sepconv`'s share of its roofline in the traced slice: the least
time of the configuration's fused separable layers at the cell's batch
(`cost.sepconv_bound`, each byte once, or the operations at peak), over
the device time of the kernel's launches, per served call (launches over
layers)."""

from harness import cost

KERNEL = "fused_sepconv_kernel"


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel(KERNEL)
    m = run.model
    layers = cost.fused_layers(run.shapes, run.cell.config["fused_layers"],
                               (m["hin"] // m["stride"],
                                m["win"] // m["stride"]))
    if not launches or not layers:
        return None
    bound = sum(cost.sepconv_bound(run.batch, *layer) for layer in layers)
    return 100.0 * bound * (launches / len(layers)) / seconds
