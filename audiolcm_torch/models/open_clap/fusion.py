"""Attentional feature fusion (DAF / AFF / iAFF) for variable-length audio
(`audiolcm_tpu/models/open_clap/fusion.py`).

Reference `ldm/modules/encoders/open_clap/feature_fusion.py`: DAF is plain
addition; AFF gates x against the residual with a sigmoid of a local
(1x1-conv bottleneck) plus a global (average-pooled bottleneck) attention;
iAFF applies the gate twice. Channels-first as in the reference: "2D" on
(B, C, H, W), "1D" on (B, C, L). The bottlenecks are the reference's
Sequentials (local: conv 0, BN 1, ReLU 2, conv 3, BN 4; global: the pool at
0 shifts them by one), so its keys load. The BatchNorms always use their
running statistics, as the JAX module does: these towers only infer.

iAFF's second gate reuses `global_att` (feature_fusion.py:124, a reference
quirk); `global_att2` is kept, never called, so a reference state dict
loads.
"""

from __future__ import annotations

import torch
from torch import nn

from audiolcm_torch.models.clap_audio import bn_eval


def daf(x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """DirectAddFuse (feature_fusion.py:11-20)."""
    return x + residual


def run_eval(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A Sequential's layers in order, its BatchNorms on running statistics."""
    for m in seq:
        x = bn_eval(m, x) if isinstance(m, nn.modules.batchnorm._BatchNorm) else m(x)
    return x


def _bottleneck(channels: int, inter: int, kind: str, pooled: bool) -> nn.Sequential:
    conv, bn, pool = ((nn.Conv2d, nn.BatchNorm2d, nn.AdaptiveAvgPool2d) if kind == "2D"
                      else (nn.Conv1d, nn.BatchNorm1d, nn.AdaptiveAvgPool1d))
    layers = [conv(channels, inter, 1), bn(inter), nn.ReLU(), conv(inter, channels, 1),
              bn(channels)]
    return nn.Sequential(*([pool(1)] if pooled else []), *layers)


class AFF(nn.Module):
    """feature_fusion.py:133-192: 2 x w + 2 residual (1 - w)."""

    def __init__(self, channels: int = 64, r: int = 4, type: str = "2D"):
        super().__init__()
        inter = channels // r
        self.local_att = _bottleneck(channels, inter, type, pooled=False)
        self.global_att = _bottleneck(channels, inter, type, pooled=True)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        xa = x + residual
        wei = torch.sigmoid(run_eval(self.local_att, xa) + run_eval(self.global_att, xa))
        return 2 * x * wei + 2 * residual * (1 - wei)


class iAFF(nn.Module):
    """feature_fusion.py:23-130: the two-stage gate."""

    def __init__(self, channels: int = 64, r: int = 4, type: str = "2D"):
        super().__init__()
        inter = channels // r
        self.local_att = _bottleneck(channels, inter, type, pooled=False)
        self.global_att = _bottleneck(channels, inter, type, pooled=True)
        self.local_att2 = _bottleneck(channels, inter, type, pooled=False)
        self.global_att2 = _bottleneck(channels, inter, type, pooled=True)  # never called

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        xa = x + residual
        wei = torch.sigmoid(run_eval(self.local_att, xa) + run_eval(self.global_att, xa))
        xi = x * wei + residual * (1 - wei)
        wei2 = torch.sigmoid(run_eval(self.local_att2, xi) + run_eval(self.global_att, xi))
        return x * wei2 + residual * (1 - wei2)


def fusion_module(fusion_type: str, channels: int):
    """The fusion of an "aff_*" / "iaff_*" / "daf_*" type: a module, or daf."""
    kind = "2D" if fusion_type.endswith("_2d") else "1D"
    if fusion_type.startswith("aff"):
        return AFF(channels, type=kind)
    if fusion_type.startswith("iaff"):
        return iAFF(channels, type=kind)
    return daf
