"""Seeded weights for both sides: one float32 normal draw on the device for
every parameter (conv kernels at He scale sqrt(2 / fan_in), biases at a
fixed small scale, the biases of the prediction convs the network names
zero, any other parameter at the network's `OTHER_STD` or else the
biases' scale), then the network's two heads centred and scaled so the
reference's maps of the first input reach the peak values a trained
network gives (max |conf| and max |paf| from the configuration), which
makes every image decode to peaks and people. The prediction biases start
at zero, so the new kernel and bias move the maps exactly."""

from __future__ import annotations

import math

import torch

from reference import models


def make(shapes: dict, seed: int, device: torch.device, bias_std: float,
         arch: str, n_stages: int) -> dict:
    """name -> float32 tensor on `device`, from `seed`, for the network
    `arch` with `n_stages` stages."""
    net = models.network(arch)
    zero = {f"{p}.bias" for p in net.predictions(n_stages)}
    if not zero <= set(shapes):
        raise KeyError(f"network {arch!r} names prediction biases the "
                       f"state_dict lacks: {sorted(zero - set(shapes))}")
    other_std = getattr(net, "OTHER_STD", bias_std)
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    stds = []
    for name in names:
        shape = shapes[name]
        if name.endswith("weight") and len(shape) > 1:      # a conv kernel
            stds.append(math.sqrt(2.0 / math.prod(shape[1:])))
        elif name in zero:
            stds.append(0.0)
        elif name.endswith("bias"):
            stds.append(bias_std)
        else:
            stds.append(other_std)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat *= torch.repeat_interleave(
        torch.tensor(stds, device=device), torch.tensor(sizes, device=device))
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(sizes))}


def scale_heads(sd: dict, arch: str, n_stages: int, image: torch.Tensor,
                conf_max: float, paf_max: float) -> tuple[float, float]:
    """Centre and scale the network's two heads (`heads(n_stages)`) in
    place: each map of `image` (1, H, W, 3) uint8 loses its mean over the
    image (through the prediction's bias), and each head's kernels and
    biases take one gain so the reference's centred maps peak at conf_max
    and paf_max. A random network's maps carry a large offset a channel;
    without it the peaks of some seeds would all sit under the decode's
    threshold. Where one head feeds the other (heatmap stages that read
    the last PAF), scaling it moves the other's maps: a head whose maps do
    not peak where they should after a pass is scaled again, from a new
    forward, until both do. Returns each head's (conf, paf) whole gain."""
    heads = models.network(arch).heads(n_stages)
    peaks = (conf_max, paf_max)
    gains = [1.0, 1.0]
    for npass in range(len(heads) + 1):
        maps = models.forward(arch, sd, image, n_stages)
        off = [i for i in range(len(heads))
               if npass == 0 or not _peaks_at(maps[i], peaks[i])]
        if not off:
            return tuple(gains)
        for i in off:
            gains[i] *= _centre(sd, heads[i], peaks[i], maps[i])
    raise RuntimeError(f"the heads of {arch!r} do not settle at "
                       f"{peaks} in {len(heads) + 1} passes")


def _centre(sd: dict, head: str, peak: float, maps: torch.Tensor) -> float:
    """Centre and scale one head so that `maps`, its output, peak at
    `peak`; returns the gain."""
    mean = maps.mean(dim=(0, 1, 2))
    gain = peak / float((maps - mean).abs().max())
    sd[f"{head}.weight"].mul_(gain)
    sd[f"{head}.bias"].copy_(gain * (sd[f"{head}.bias"] - mean))
    return gain


def _peaks_at(maps: torch.Tensor, peak: float, rel: float = 1e-3) -> bool:
    """Centred maps whose largest magnitude is `peak`, to `rel`."""
    mean = maps.mean(dim=(0, 1, 2))
    return (abs(float((maps - mean).abs().max()) / peak - 1.0) <= rel
            and float(mean.abs().max()) <= rel * peak)
