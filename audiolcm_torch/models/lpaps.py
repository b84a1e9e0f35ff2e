"""LPAPS, the learned perceptual distance over mel spectrograms
(`audiolcm_tpu/models/lpaps.py`).

Reference `ldm/modules/losses_audio/lpaps.py` (LPIPS adapted by
SpecVQGAN): a per-frequency ScalingLayer, the VGGishish16 trunk (a VGG16
conv stack without BatchNorm, tapped after convs 2, 4, 7, 10 and 13),
unit-normalised features along channels (f / (sqrt(sum f^2) + 1e-10)),
squared differences, 1x1 NetLin heads without bias and a spatial mean,
summed over the five taps. Max-pooling floors odd sizes. NCHW mels
(B, 1, F, T) in [-1, 1] -> (B, 1, 1, 1).

State dicts keep the reference layout: `net.slice{1..5}.<idx>.weight/bias`
(the torchvision feature indices), `lin{k}.model.1.weight`,
`scaling_layer.shift/scale` (1, 1, F, 1). `load_lpaps` takes the
reference's mean/std file of 10 s mels and remaps its [0, 1] statistics to
[-1, 1], as the reference's ScalingLayer does. The weights are an external
download; nothing here fetches them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

VGG_PLAN = (64, 64, "MP", 128, 128, "MP", 256, 256, 256, "MP",
            512, 512, 512, "MP", 512, 512, 512)
LPAPS_CHANNELS = (64, 128, 256, 512, 512)
SLICE_ENDS = (4, 9, 16, 23, 30)  # torchvision feature index where each slice ends


class VGGishish16(nn.Module):
    """The VGG16 trunk as five slices (Sequentials keyed by the feature
    index); forward returns the five slice outputs."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 1
        for item in VGG_PLAN:
            if item == "MP":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c_in, item, 3, padding=1), nn.ReLU()]
                c_in = item
        start = 0
        for k, end in enumerate(SLICE_ENDS):
            s = nn.Sequential()
            for idx in range(start, end):
                s.add_module(str(idx), layers[idx])
            setattr(self, f"slice{k + 1}", s)
            start = end

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for k in range(len(SLICE_ENDS)):
            x = getattr(self, f"slice{k + 1}")(x)
            taps.append(x)
        return taps


class ScalingLayer(nn.Module):
    def __init__(self, n_freq: int = 80):
        super().__init__()
        self.register_buffer("shift", torch.zeros(1, 1, n_freq, 1))
        self.register_buffer("scale", torch.ones(1, 1, n_freq, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """Dropout (eval: identity) + 1x1 conv to one channel, no bias."""

    def __init__(self, c_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(c_in, 1, 1, bias=False))


def normalize_tensor(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


class LPAPS(nn.Module):
    """Frozen perceptual distance: (x, y) mels (B, 1, F, T) -> (B, 1, 1, 1)."""

    def __init__(self, n_freq: int = 80):
        super().__init__()
        self.scaling_layer = ScalingLayer(n_freq)
        self.net = VGGishish16()
        for k, c in enumerate(LPAPS_CHANNELS):
            setattr(self, f"lin{k}", NetLinLayer(c))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        outs0 = self.net(self.scaling_layer(x))
        outs1 = self.net(self.scaling_layer(y))
        val = 0.0
        for k, (f0, f1) in enumerate(zip(outs0, outs1)):
            diff = (normalize_tensor(f0) - normalize_tensor(f1)) ** 2
            head = getattr(self, f"lin{k}").model[1]
            val = val + torch.mean(head(diff), dim=(2, 3), keepdim=True)
        return val


def scaling_from_mean_std(mean_std: np.ndarray) -> dict:
    """The reference's stats file ((F, 2) means and stds of [0, 1] mels) ->
    the ScalingLayer buffers for [-1, 1] mels."""
    means, stds = np.asarray(mean_std, np.float32).T
    return {"scaling_layer.shift": torch.from_numpy(2 * means - 1)[None, None, :, None],
            "scaling_layer.scale": torch.from_numpy(2 * stds)[None, None, :, None]}


def load_lpaps(state_dict: dict, mean_std: Optional[np.ndarray] = None,
               n_freq: int = 80, device=None) -> LPAPS:
    """A reference-layout LPAPS state dict -> the frozen module in eval mode
    on `device` (the CPU unless told otherwise). The ScalingLayer comes from
    `mean_std` when given, else from the state dict, else shift 0, scale 1."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    if mean_std is not None:
        sd.update(scaling_from_mean_std(mean_std))
        n_freq = sd["scaling_layer.shift"].shape[2]
    elif "scaling_layer.shift" in sd:
        n_freq = sd["scaling_layer.shift"].numel()
        sd["scaling_layer.shift"] = sd["scaling_layer.shift"].reshape(1, 1, -1, 1)
        sd["scaling_layer.scale"] = sd["scaling_layer.scale"].reshape(1, 1, -1, 1)
    model = LPAPS(n_freq)
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not k.startswith("scaling_layer.")]
    if missing:
        raise KeyError(f"LPAPS: state dict lacks {missing[:5]}")
    model.load_state_dict({k: sd.get(k, own[k]) for k in own})
    return model.eval().requires_grad_(False).to(device or "cpu")


def lpaps_perceptual(model: LPAPS):
    """The variant steps' perceptual_fn: mels (B, T, F) -> (B,) distances."""

    def fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        to_img = lambda m: m.transpose(1, 2)[:, None]
        return model(to_img(x), to_img(y)).reshape(-1)

    return fn
