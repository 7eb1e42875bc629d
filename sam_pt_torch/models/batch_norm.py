"""BatchNorm at inference, shared by the models that carry it (RAFT's
encoders, TinyViT's `Conv2d_BN`, SuperGlue's MLPs), and the reset that random
builds need."""
from __future__ import annotations

import torch
from torch import nn


class InferenceBatchNorm(nn.Module):
    """BatchNorm at inference over dim 1 of [B, C, ...] (BatchNorm1d's and
    BatchNorm2d's layouts): (x - mean) * rsqrt(var + 1e-5) * weight +
    bias, with the running statistics as buffers."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_running_stats(self) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        shape = (-1,) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


def reset_batch_norm_stats_(module: nn.Module) -> nn.Module:
    """Give every InferenceBatchNorm of `module` an untrained one's running
    statistics (mean 0, variance 1): random draws would make variances
    negative."""
    for m in module.modules():
        if isinstance(m, InferenceBatchNorm):
            m.reset_running_stats()
    return module
