"""Random weights from the seed, in the reference layout, on the device.

One normal draw fills a single flat buffer for all five models, in the
dtype they are served in, from a generator on the device; each tensor is a
view of it, scaled in place by its init rule (the scaling of the port's
smoke script's `init_random_`):

- two or more dims: N(0, (fan-in)^-1), fan-in = the numel of one output
  row, 0.01x for the vocoder's `conv_post` (keeps the final tanh out of
  saturation);
- snake `alpha` / `beta` (log scale): N(0, 0.1^2);
- other 1-D `weight` (norm scales): N(1, 0.02^2); other 1-D: N(0, 0.02^2);
- a configuration's `init_scale` multiplies the std of the keys that end
  in each of its suffixes (the published init of a model whose forward
  relies on it, such as T5's query scaling).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.layout import layouts

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _rule(model: str, key: str, shape, extra: dict) -> tuple:
    """(mean, std) of one tensor."""
    if len(shape) >= 2:
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        std = fan_in ** -0.5 * (0.01 if (model, key) == ("vocoder", "conv_post.weight") else 1.0)
        mean = 0.0
    elif key.endswith(("alpha", "beta")):
        mean, std = 0.0, 0.1
    elif key.endswith("weight"):
        mean, std = 1.0, 0.02
    else:
        mean, std = 0.0, 0.02
    for suffix, scale in extra.get(model, {}).items():
        if key.endswith(suffix):
            std *= scale
    return mean, std


def make_state_dicts(config: dict, seed: int, device, dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: {key: tensor}} for the configuration's five models."""
    lay = layouts(config)
    total = sum(torch.Size(s).numel() for entries in lay.values() for _, s in entries)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=torch.Generator(device=device).manual_seed(seed % 2 ** 63))
    extra = config.get("init_scale", {})
    out, offset = {}, 0
    with torch.no_grad():
        for model, entries in lay.items():
            sd = {}
            for key, shape in entries:
                n = torch.Size(shape).numel()
                t = flat[offset:offset + n].view(shape)
                offset += n
                mean, std = _rule(model, key, shape, extra)
                t.mul_(std)
                if mean:
                    t.add_(mean)
                sd[key] = t
            out[model] = sd
    return out

