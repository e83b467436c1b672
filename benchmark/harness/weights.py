"""Seeded weights for both sides: one float32 normal draw on the device for
every parameter (conv kernels at He scale sqrt(2 / fan_in), biases at a
fixed small scale, the biases of the prediction convs the network names
zero, any other parameter at the network's `OTHER_STD` or else the
biases' scale), then whatever the network's decode family's `init`
makes instead, from the same generator; then the network's heads
centred and scaled by its family's head rule, so that the reference's
maps of the first input reach the peak values a trained network gives
(the configuration's `weights`), which makes every image decode to peaks
and people. The prediction biases start at zero, so the new kernel and
bias move the maps exactly."""

from __future__ import annotations

import math

import torch

from reference import models


def make(shapes: dict, seed: int, device: torch.device, bias_std: float,
         model: dict) -> dict:
    """name -> float32 tensor on `device`, from `seed`, for the network
    of the configuration's model section `model`."""
    net = models.network(model["name"])
    zero = {f"{p}.bias" for p in net.predictions(model)}
    if not zero <= set(shapes):
        raise KeyError(f"network {model['name']!r} names prediction biases "
                       f"the state_dict lacks: {sorted(zero - set(shapes))}")
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
    sd = {n: t.view(shapes[n]) for n, t in zip(names, flat.split(sizes))}
    init = getattr(models.family(net), "init", None)
    if init is not None:
        for name in names:
            t = init(name, tuple(shapes[name]), gen)
            if t is not None:
                sd[name] = t.to(device, torch.float32).view(shapes[name])
    return sd


def scale_heads(sd: dict, model: dict, image: torch.Tensor, peaks: dict
                ) -> tuple:
    """Centre and scale the network's heads in place, by its family's
    head rule: each rule's channels of the maps of `image` (1, H, W, 3)
    uint8 lose their mean over the image (through the head's bias), and
    the rule's output channels of the head's kernel and bias take one gain
    so the reference's centred maps peak at `peaks[weight key]` (the
    configuration's `weights`). A random network's maps carry a large
    offset a channel; without it the peaks of some seeds would all sit
    under the decode's threshold. Where one head feeds another (later
    layers that read an earlier prediction), scaling it moves the other's
    maps: a rule whose maps do not peak where they should after a pass is
    scaled again, from a new forward, until all do. Returns each rule's
    whole gain."""
    net = models.network(model["name"])
    fam = models.family(net)
    rules = fam.head_rule(net, model, fam.skeleton(net))
    want = [peaks[key] for _, _, _, key in rules]
    gains = [1.0] * len(rules)
    for npass in range(len(rules) + 1):
        maps = models.forward(model, sd, image)
        got = [maps[i] if ch is None else maps[i][..., ch]
               for _, i, ch, _ in rules]
        off = [k for k in range(len(rules))
               if npass == 0 or not _peaks_at(got[k], want[k])]
        if not off:
            return tuple(gains)
        for k in off:
            head, _, ch, _ = rules[k]
            gains[k] *= _centre(sd, head, ch, want[k], got[k])
    raise RuntimeError(f"the heads of {model['name']!r} do not settle at "
                       f"{want} in {len(rules) + 1} passes")


def _centre(sd: dict, head: str, channels, peak: float,
            maps: torch.Tensor) -> float:
    """Centre and scale one head's `channels` (a slice, None for all) so
    that `maps`, their output, peak at `peak`; returns the gain."""
    mean = maps.mean(dim=(0, 1, 2))
    gain = peak / float((maps - mean).abs().max())
    weight, bias = sd[f"{head}.weight"], sd[f"{head}.bias"]
    if channels is not None:
        weight, bias = weight[channels], bias[channels]
    weight.mul_(gain)
    bias.copy_(gain * (bias - mean))
    return gain


def _peaks_at(maps: torch.Tensor, peak: float, rel: float = 1e-3) -> bool:
    """Centred maps whose largest magnitude is `peak`, to `rel`."""
    mean = maps.mean(dim=(0, 1, 2))
    return (abs(float((maps - mean).abs().max()) / peak - 1.0) <= rel
            and float(mean.abs().max()) <= rel * peak)
