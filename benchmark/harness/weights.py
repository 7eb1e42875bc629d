"""Random checkpoints from the seed, in the public names that the
reference lists (`segment_anything`'s for SAM, the tracker's own), drawn on
the device by one generator in one call a checkpoint, in the dtype each
part is served in.

One rule for every tensor: a learned matrix (two dimensions or more) is
drawn ~ N(0, std^2); a one-dimensional weight (every one in these models
is a norm's) is 1 and every bias 0, their published initialisation. A
buffer that the model defines at initialisation and never learns keeps its
published draw: the configuration's `published_std` names each with its
standard deviation (SAM's random Fourier features, N(0, 1)).

The configuration's `weights` then adjust a few entries, on the same dicts
that both sides get: `set` fills whole tensors with a value (output biases
that keep paths live which random weights leave dead: points visible, IoU
scores around the gate), and `scale_columns` multiplies a weight's input
columns (a random tracker's input columns from its sinusoidal flow
embedding, whose high frequencies make the track a chaotic function of its
input: a change of 1e-4 px moves a random CoTracker's points by pixels; the
IoU head's last layer, so that its scores spread across the gate)."""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def draw(shapes: dict, dtype: torch.dtype, std: float, published: dict,
         gen: torch.Generator, device) -> dict:
    """{name: tensor} views of one flat N(0, 1) draw, set by the rule in
    the module's doc."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, i = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        t = flat[i:i + n].view(shape)
        if name in published:
            t.mul_(published[name])
        elif len(shape) >= 2:
            t.mul_(std)
        else:
            t.fill_(0.0 if name.endswith("bias") else 1.0)
        out[name] = t
        i += n
    return out


def checkpoints(config: dict, shapes: dict, seed: int, device) -> dict:
    """{"sam": state dict, "tracker": state dict} for `shapes` (the
    reference's `param_shapes`) in each part's configured dtype, adjusted
    by the configuration's `weights`."""
    adjust = config["weights"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for part in ("sam", "tracker"):
        out[part] = draw(shapes[part], DTYPES[config[part]["dtype"]],
                         adjust["std"],
                         adjust.get("published_std", {}).get(part, {}),
                         gen, device)
        for name, value in adjust.get("set", {}).get(part, {}).items():
            out[part][name].fill_(value)
        for name, start, stop, factor in adjust.get("scale_columns", {}).get(
                part, []):
            out[part][name][:, start:stop].mul_(factor)
    return out
