"""Exponential moving average of parameters (`audiolcm_tpu/train/ema.py`).

`ldm/modules/ema.py` (LitEma): decay 0.9999 with the warm-up
min(decay, (1+n)/(10+n)). The LCM target net keeps its own fixed 0.95
rate inside train/lcm_distill.py; `use_ema: false` in the shipped configs,
so this serves the optional EMA evaluation path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch
from torch import nn

Params = Union[nn.Module, Dict[str, torch.Tensor]]


def _tensors(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return {k: p.detach() for k, p in params.named_parameters()}
    return {k: v.detach() for k, v in params.items()}


@dataclasses.dataclass
class EMAState:
    params: Dict[str, torch.Tensor]
    num_updates: int = 0


def ema_init(params: Params) -> EMAState:
    """A copy of a module's parameters (or of a state dict's tensors)."""
    return EMAState({k: v.clone() for k, v in _tensors(params).items()}, 0)


def ema_update(state: EMAState, new_params: Params, decay: float = 0.9999) -> EMAState:
    """ema <- ema - (1 - d) * (ema - p), d = min(decay, (1+n)/(10+n)) with n
    the count after this update (float32, as the JAX function computes it),
    in place on the EMA tensors."""
    n = state.num_updates + 1
    nf = torch.tensor(float(n), dtype=torch.float32)
    d = torch.clamp((1.0 + nf) / (10.0 + nf), max=decay)
    w = float(1.0 - d)
    new = _tensors(new_params)
    ema = [state.params[k] for k in new]
    diff = torch._foreach_sub(ema, [new[k] for k in new])
    torch._foreach_mul_(diff, w)
    torch._foreach_sub_(ema, diff)
    return EMAState(state.params, n)
