"""SuperGlue attentional keypoint matcher (counterpart of
`sam_pt_tpu/models/tracker/superglue/superglue.py`), on a batch of image
pairs.

The keypoint encoder, alternating self and cross attentional propagation
(9 pairs, 4 heads, 256 wide), the final projection, the score matrix with
a learned dustbin through log-domain Sinkhorn in float32, and mutual-max
matching with a threshold. Every image has K keypoint slots with a
validity mask: invalid slots are masked out of attention (-1e9) and their
rows and columns of the score matrix, as in the JAX package.

The modules and parameters are magicleap's (`kenc.encoder.{0,1,3,4,...,12}`,
`gnn.layers.{i}.attn.proj.{0,1,2}`, `attn.merge`, `mlp.{0,1,3}`,
`final_proj`, `bin_score`), channels first, and so is the attention's
head layout: channel `d * heads + h` is dimension d of head h. A public
`superglue_{indoor,outdoor}.pth` loads as it is
(`utils/checkpoint.py::load_superglue_checkpoint`); the JAX package splits
heads contiguously (channel `h * 64 + d`), so its parameters come through
`superglue_state_dict_from_jax`, which permutes them (F9, ROADMAP §3).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ...batch_norm import InferenceBatchNorm

# magicleap's published configuration: 256 wide, the keypoint encoder's
# widths, 9 self/cross pairs (of 4 heads each).
DESCRIPTOR_DIM = 256
KEYPOINT_ENCODER = (32, 64, 128, 256)
GNN_LAYERS = 9


def mlp(channels: Sequence[int]) -> nn.Sequential:
    """magicleap's MLP: 1 x 1 Conv1d layers, BatchNorm and ReLU after each
    but the last."""
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], 1))
        if i < len(channels) - 1:
            layers += [InferenceBatchNorm(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


class KeypointEncoder(nn.Module):
    def __init__(self, feature_dim: int, layers: Sequence[int]):
        super().__init__()
        self.encoder = mlp([3, *layers, feature_dim])

    def forward(self, kpts: torch.Tensor, scores: torch.Tensor):
        """kpts [B, N, 2] normalised, scores [B, N] -> [B, D, N]."""
        return self.encoder(torch.cat([kpts.transpose(1, 2),
                                       scores[:, None]], dim=1))


class MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        self.dim = d_model // num_heads
        self.num_heads = num_heads
        self.merge = nn.Conv1d(d_model, d_model, 1)
        self.proj = nn.ModuleList([nn.Conv1d(d_model, d_model, 1)
                                   for _ in range(3)])

    def forward(self, query, key, value, key_valid):
        """[B, D, N] queries against [B, D, M] keys and values; key_valid
        [B, M] bool -> [B, D, N]."""
        b = query.shape[0]
        q, k, v = (proj(x).view(b, self.dim, self.num_heads, -1)
                   for proj, x in zip(self.proj, (query, key, value)))
        scores = torch.einsum("bdhn,bdhm->bhnm", q, k) / self.dim ** 0.5
        scores = scores.masked_fill(~key_valid[:, None, None, :], -1e9)
        prob = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        x = torch.einsum("bhnm,bdhm->bdhn", prob, v)
        return self.merge(x.reshape(b, self.dim * self.num_heads, -1))


class AttentionalPropagation(nn.Module):
    def __init__(self, feature_dim: int, num_heads: int):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, feature_dim)
        self.mlp = mlp([feature_dim * 2, feature_dim * 2, feature_dim])

    def forward(self, x, source, source_valid):
        """The message of `source` to `x`, through the MLP: x's update."""
        message = self.attn(x, source, source, source_valid)
        return self.mlp(torch.cat([x, message], dim=1))


class AttentionalGNN(nn.Module):
    def __init__(self, feature_dim: int, layer_names: Sequence[str]):
        super().__init__()
        self.layers = nn.ModuleList([AttentionalPropagation(feature_dim, 4)
                                     for _ in layer_names])
        self.names = list(layer_names)

    def forward(self, desc0, desc1, valid0, valid1):
        """Both images of every pair as one batch of 2B."""
        b = desc0.shape[0]
        desc = torch.cat([desc0, desc1])
        valid = torch.cat([valid0, valid1])
        swapped = torch.cat([b + torch.arange(b), torch.arange(b)]).to(
            desc.device)
        for layer, name in zip(self.layers, self.names):
            if name == "cross":
                desc = desc + layer(desc, desc[swapped], valid[swapped])
            else:
                desc = desc + layer(desc, desc, valid)
        return desc[:b], desc[b:]


def log_sinkhorn(scores: torch.Tensor, alpha: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Log-domain Sinkhorn with a learned dustbin row and column, float32:
    scores [B, M, N] -> the log transport plan [B, M+1, N+1]."""
    b, m, n = scores.shape
    scores = scores.float()
    alpha = alpha.float()
    couplings = torch.cat([
        torch.cat([scores, alpha.expand(b, m, 1)], dim=2),
        torch.cat([alpha.expand(b, 1, n), alpha.expand(b, 1, 1)], dim=2),
    ], dim=1)
    ms = torch.tensor(float(m), device=scores.device)
    ns = torch.tensor(float(n), device=scores.device)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([norm.expand(m), (torch.log(ns) + norm)[None]])
    log_nu = torch.cat([norm.expand(n), (torch.log(ms) + norm)[None]])
    u = torch.zeros(b, m + 1, device=scores.device)
    v = torch.zeros(b, n + 1, device=scores.device)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm


def normalize_keypoints(kpts: torch.Tensor, hw: Tuple[int, int]):
    """Pixel (x, y) -> centred on the image, over 0.7 of its longer side."""
    h, w = hw
    size = torch.tensor([float(w), float(h)], device=kpts.device)
    return (kpts - size / 2) / (size.max() * 0.7)


class SuperGlue(nn.Module):
    descriptor_dim = DESCRIPTOR_DIM

    def __init__(self, sinkhorn_iterations: int = 100,
                 match_threshold: float = 0.2):
        super().__init__()
        self.sinkhorn_iterations = sinkhorn_iterations
        self.match_threshold = match_threshold
        self.kenc = KeypointEncoder(DESCRIPTOR_DIM, KEYPOINT_ENCODER)
        self.gnn = AttentionalGNN(DESCRIPTOR_DIM,
                                  ["self", "cross"] * GNN_LAYERS)
        self.final_proj = nn.Conv1d(DESCRIPTOR_DIM, DESCRIPTOR_DIM, 1)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def log_transport(self, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The log transport plan [B, K0+1, K1+1] of each pair."""
        hw = data["image_shape"]
        v0, v1 = data["valid0"], data["valid1"]
        d0 = data["descriptors0"].transpose(1, 2) + self.kenc(
            normalize_keypoints(data["keypoints0"], hw), data["scores0"])
        d1 = data["descriptors1"].transpose(1, 2) + self.kenc(
            normalize_keypoints(data["keypoints1"], hw), data["scores1"])
        d0, d1 = self.gnn(d0, d1, v0, v1)
        m0, m1 = self.final_proj(d0), self.final_proj(d1)
        scores = torch.einsum("bdn,bdm->bnm", m0, m1) / DESCRIPTOR_DIM ** 0.5
        scores = scores.masked_fill(~(v0[:, :, None] & v1[:, None, :]), -1e9)
        return log_sinkhorn(scores, self.bin_score, self.sinkhorn_iterations)

    def forward(self, data: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """data: keypoints{0,1} [B, K, 2] (x, y), scores{0,1} [B, K],
        valid{0,1} [B, K] bool, descriptors{0,1} [B, K, D], image_shape
        (h, w). Returns matches0 [B, K] int64 (-1: unmatched),
        matching_scores0 [B, K] and the log transport plan."""
        z = self.log_transport(data)
        inner = z[:, :-1, :-1]
        max0, idx0 = inner.max(dim=2)
        idx1 = inner.argmax(dim=1)
        mutual0 = torch.arange(inner.shape[1], device=z.device)[None] == (
            idx1.gather(1, idx0))
        mscores0 = torch.where(mutual0, max0.exp(), torch.zeros_like(max0))
        keep = mutual0 & (mscores0 > self.match_threshold) & data["valid0"]
        return {"matches0": torch.where(keep, idx0, torch.full_like(idx0, -1)),
                "matching_scores0": mscores0, "log_transport": z}
