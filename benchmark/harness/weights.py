"""Seeded weights for both sides: one float32 normal draw on the device for
every parameter (kernels at He scale sqrt(2 / fan_in), biases at a fixed
small scale, the prediction convs' biases zero), then the last stage's
predictions centred and scaled so the reference's maps of the first input
reach the peak values a trained network gives (max |conf| and max |paf|
from the configuration), which makes every image decode to peaks and
people. The prediction biases start at zero, so the new kernel and bias
move the maps exactly."""

from __future__ import annotations

import math

import torch

from reference import models


def make(shapes: dict, seed: int, device: torch.device,
         bias_std: float) -> dict:
    """name -> float32 tensor on `device`, from `seed`."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    stds = []
    for name in names:
        if name.endswith("weight"):
            stds.append(math.sqrt(2.0 / math.prod(shapes[name][1:])))
        else:
            stds.append(0.0 if name.endswith("Conv_0.bias") else bias_std)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat *= torch.repeat_interleave(
        torch.tensor(stds, device=device), torch.tensor(sizes, device=device))
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(sizes))}


def scale_heads(sd: dict, arch: str, n_stages: int, image: torch.Tensor,
                conf_max: float, paf_max: float) -> None:
    """Centre and scale the last stage's predictions in place: each map of
    `image` (1, H, W, 3) uint8 loses its mean over the image (through the
    prediction's bias), and each head's kernels and biases take one gain
    so the reference's centred maps peak at conf_max and paf_max. A random
    network's maps carry a large offset a channel; without it the peaks
    of some seeds would all sit under the decode's threshold."""
    conf, paf = models.forward(arch, sd, image, n_stages)
    for key, peak, maps in (("conf", conf_max, conf), ("paf", paf_max, paf)):
        mean = maps.mean(dim=(0, 1, 2))
        gain = peak / float((maps - mean).abs().max())
        head = f"stages.stage{n_stages}_{key}.Conv_0"
        sd[f"{head}.weight"].mul_(gain)
        sd[f"{head}.bias"].copy_(-gain * mean)
