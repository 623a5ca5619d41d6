"""Per-anchor out-of-distribution scores over class logits (port of
``ood_object_detection_tpu.ops.ood``). Higher = more in-distribution."""
from __future__ import annotations

import torch


def energy_score(logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Negative free energy: T * logsumexp(logits / T) over the class axis,
    computed as max + log(sum(exp(x - max))) like jax's logsumexp."""
    x = logits / temperature
    m = torch.amax(x, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    out = torch.log(torch.sum(torch.exp(x - m), dim=-1)) + m.squeeze(-1)
    return temperature * out


def max_logit_score(logits: torch.Tensor) -> torch.Tensor:
    """Max unnormalized logit over classes."""
    return torch.amax(logits, dim=-1)


def msp_score(logits: torch.Tensor) -> torch.Tensor:
    """Max per-class sigmoid (the sigmoid detector's analogue of MSP)."""
    return torch.amax(torch.sigmoid(logits), dim=-1)


_SCORERS = {
    "energy": energy_score,
    "max_logit": max_logit_score,
    "msp": msp_score,
}


def ood_score(logits: torch.Tensor, method: str = "energy", **kwargs) -> torch.Tensor:
    return _SCORERS[method](logits, **kwargs)
