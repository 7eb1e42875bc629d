"""Plain PyTorch point trackers: CoTracker v1 (stride 4, window 8, the
`cotracker_stride_4_wind_8` checkpoint's names) and PIPS (the public
`reference_model` checkpoint's names), each with the windowing that SAM-PT
runs it with, in float32 unless a `Precision` says otherwise.

Both share PIPS's BasicEncoder (instance-normed residual CNN, four stages
resized with align_corners and fused) and the correlation pyramid (4
levels of 2x2 average pooling, bilinear taps at radius 3, zero outside).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .ops import (F32, Precision, attention, bilinear_at, conv2d, gelu,
                  layer_norm, linear, matmul, resize, sincos_1d, sincos_grid,
                  sincos_interleaved, window_taps)

LATENT = 128
CORR_LEVELS, CORR_RADIUS = 4, 3
CORR_DIM = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2  # 196
STAGES = ((64, 64, 1), (64, 96, 2), (96, 128, 2), (128, 128, 2))


def encoder_shapes(prefix: str = "fnet.") -> dict:
    s = {prefix + "conv1.weight": (64, 3, 7, 7), prefix + "conv1.bias": (64,)}
    for i, (cin, cout, stride) in enumerate(STAGES, start=1):
        for j in range(2):
            p = f"{prefix}layer{i}.{j}."
            s[p + "conv1.weight"] = (cout, cin if j == 0 else cout, 3, 3)
            s[p + "conv1.bias"] = (cout,)
            s[p + "conv2.weight"] = (cout, cout, 3, 3)
            s[p + "conv2.bias"] = (cout,)
            if j == 0 and stride != 1:
                s[p + "downsample.0.weight"] = (cout, cin, 1, 1)
                s[p + "downsample.0.bias"] = (cout,)
    s[prefix + "conv2.weight"] = (2 * LATENT, 416, 3, 3)
    s[prefix + "conv2.bias"] = (2 * LATENT,)
    s[prefix + "conv3.weight"] = (LATENT, 2 * LATENT, 1, 1)
    s[prefix + "conv3.bias"] = (LATENT,)
    return s


def _lin_shapes(name, o, i):
    return {name + ".weight": (o, i), name + ".bias": (o,)}


def _head_shapes() -> dict:
    s = {"norm.weight": (LATENT,), "norm.bias": (LATENT,)}
    s.update(_lin_shapes("ffeat_updater.0", LATENT, LATENT))
    s.update(_lin_shapes("vis_predictor.0", 1, LATENT))
    return s


def _instance_norm(x):
    return F.instance_norm(x, eps=1e-5)


def basic_encoder(frames, sd, stride: int, p: Precision):
    """Frames [T, 3, H, W] in [-1, 1] -> features [T, C, H/s, W/s]."""
    target = (frames.shape[-2] // stride, frames.shape[-1] // stride)
    x = F.relu(_instance_norm(conv2d(frames, sd, "fnet.conv1", p, stride=2,
                                     padding=3)))
    feats = []
    for i, (_, _, st) in enumerate(STAGES, start=1):
        for j in range(2):
            b = f"fnet.layer{i}.{j}."
            y = F.relu(_instance_norm(conv2d(x, sd, b + "conv1", p,
                                             stride=st if j == 0 else 1,
                                             padding=1)))
            y = F.relu(_instance_norm(conv2d(y, sd, b + "conv2", p, padding=1)))
            if j == 0 and st != 1:
                x = _instance_norm(conv2d(x, sd, b + "downsample.0", p,
                                          stride=st))
            x = F.relu(x + y)
        feats.append(resize(x, target, align_corners=True))
    x = F.relu(_instance_norm(conv2d(torch.cat(feats, 1), sd, "fnet.conv2", p,
                                     padding=1)))
    return conv2d(x, sd, "fnet.conv3", p)


def encode_video(video, sd, stride, p, hw=None, chunk: int = 8):
    """[T, H, W, 3] uint8 -> features [T, C, h, w], resized to `hw` first."""
    out = []
    for i in range(0, video.shape[0], chunk):
        x = video[i:i + chunk].float().permute(0, 3, 1, 2)
        if hw is not None:
            x = resize(x, hw)
        out.append(basic_encoder(2 * (x / 255.0) - 1, sd, stride, p))
    return torch.cat(out)


def corr_taps(fmaps, feats, coords, p: Precision):
    """fmaps [S, C, H, W], feats [S, N, C], coords [S, N, 2] (feature
    pixels) -> [S, N, 196]."""
    s, c = fmaps.shape[:2]
    out = []
    fm = fmaps
    for lvl in range(CORR_LEVELS):
        corr = matmul(feats, fm.reshape(s, c, -1), p) / c ** 0.5
        corr = corr.reshape(s, -1, *fm.shape[-2:])
        centres = coords / 2.0 ** lvl
        out.append(window_taps(corr, centres[..., 0], centres[..., 1],
                               CORR_RADIUS))
        if lvl < CORR_LEVELS - 1:
            fm = F.avg_pool2d(fm, 2, 2)
    return torch.cat(out, -1)


# ----------------------------------------------------------------------------
# CoTracker v1
# ----------------------------------------------------------------------------

COTRACKER = dict(input_dim=456, hidden=384, heads=8, depth=6, mlp_ratio=4)


def cotracker_shapes(tracker: dict) -> dict:
    c = COTRACKER
    h, m = c["hidden"], c["hidden"] * c["mlp_ratio"]
    s = encoder_shapes()
    s.update(_lin_shapes("updateformer.input_transform", h, c["input_dim"]))
    for kind in ("time_blocks", "space_blocks"):
        for i in range(c["depth"]):
            b = f"updateformer.{kind}.{i}."
            s.update(_lin_shapes(b + "attn.qkv", 3 * h, h))
            s.update(_lin_shapes(b + "attn.proj", h, h))
            s.update(_lin_shapes(b + "mlp.fc1", m, h))
            s.update(_lin_shapes(b + "mlp.fc2", h, m))
    s.update(_lin_shapes("updateformer.flow_head", LATENT + 2, h))
    s.update(_head_shapes())
    return s


def _attn_block(x, sd, b, p, key_mask=None):
    heads = COTRACKER["heads"]
    n, l, c = x.shape
    y = F.layer_norm(x, (c,), eps=1e-6)
    qkv = linear(y, sd, b + "attn.qkv", p).reshape(n, l, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    mask = None if key_mask is None else key_mask[None, None, None, :]
    y = attention(q, k, v, p, (c // heads) ** -0.5, key_mask=mask)
    x = x + linear(y.transpose(1, 2).reshape(n, l, c), sd, b + "attn.proj", p)
    y = F.layer_norm(x, (c,), eps=1e-6)
    y = gelu(linear(y, sd, b + "mlp.fc1", p), tanh=True)
    return x + linear(y, sd, b + "mlp.fc2", p)


def cotracker_window(fmaps, coords, feats, track_mask, vis_init, active, sd,
                     iters, p: Precision):
    """One window: fmaps [S, C, h, w], coords [S, N, 2] (feature pixels),
    feats [N, C], track_mask, vis_init [S, N], active [N] -> (coords
    [S, N, 2], visibility logits [S, N])."""
    s, c, h, w = fmaps.shape
    dim = COTRACKER["input_dim"]
    table = sincos_grid(dim, h, w, fmaps.device).permute(2, 0, 1)
    pos = bilinear_at(table, coords[0, :, 0], coords[0, :, 1])  # [N, dim]
    times = sincos_1d(torch.arange(s, dtype=torch.float32,
                                   device=fmaps.device), dim)
    ffeats = feats[None].expand(s, -1, -1)
    for _ in range(iters):
        fcorr = corr_taps(fmaps, ffeats, coords, p)
        flow = coords - coords[:1]
        flow_emb = torch.cat([flow, sincos_interleaved(flow[..., 0], 64),
                              sincos_interleaved(flow[..., 1], 64)], -1)
        tokens = torch.cat([flow_emb, fcorr, ffeats, track_mask[..., None],
                            vis_init[..., None]], -1)
        tokens = tokens + pos[None] + times[:, None]
        x = linear(tokens.transpose(0, 1), sd,
                   "updateformer.input_transform", p)  # [N, S, hidden]
        for i in range(COTRACKER["depth"]):
            x = _attn_block(x, sd, f"updateformer.time_blocks.{i}.", p)
            x = _attn_block(x.transpose(0, 1), sd,
                            f"updateformer.space_blocks.{i}.", p,
                            active).transpose(0, 1)
        delta = linear(x, sd, "updateformer.flow_head", p).transpose(0, 1)
        upd = layer_norm(delta[..., 2:], sd, "norm", 1e-5)
        ffeats = ffeats + gelu(linear(upd, sd, "ffeat_updater.0", p))
        coords = coords + delta[..., :2]
    return coords, linear(ffeats, sd, "vis_predictor.0", p)[..., 0]


def _cotracker_pass(fmaps, queries, t, sd, s, iters, p):
    """CoTracker v1's sliding windows (start 0, S/2, ...) over fmaps
    [t, C, h, w] for queries [N, 3] (t, x, y in feature pixels): each
    window takes the tracks whose query frame is before its end; tracks
    carried from the previous window start from its predictions. Returns
    traj [t, N, 2] (feature pixels; 0 before a track's first window) and
    visibility logits [t, N]."""
    n = queries.shape[0]
    dev = fmaps.device
    q_t = queries[:, 0].long()
    q_xy = queries[:, 1:]
    feats = torch.stack([bilinear_at(fmaps[int(q_t[i])], q_xy[i:i + 1, 0],
                                     q_xy[i:i + 1, 1])[0] for i in range(n)])
    traj = torch.zeros((t + s, n, 2), device=dev)
    vis = torch.zeros((t + s, n), device=dev)
    prev = -(t + s)
    for ind in range(0, t - s // 2, s // 2):
        raw = ind + torch.arange(s, device=dev)
        frames = raw.clamp(max=t - 1)
        real = (raw < t).float()
        active = q_t < ind + s
        fresh = q_t >= prev + s
        own = (frames[:, None] >= q_t[None, :]).float()
        carried = (raw >= ind + s // 2).float()[:, None].expand(s, n)
        tm = torch.where(fresh[None], own, carried) * real[:, None]
        init = frames.clamp(max=prev + s - 1).clamp(0, t - 1)
        c0 = torch.where(fresh[None, :, None], q_xy[None].expand(s, n, 2),
                         traj[init])
        v0 = torch.where(fresh[None], torch.full((s, n), 10.0, device=dev),
                         vis[init])
        cw, vw = cotracker_window(fmaps[frames], c0, feats, tm, v0, active,
                                  sd, iters, p)
        write = (real[:, None] * active[None].float()) > 0
        traj[ind:ind + s] = torch.where(write[..., None], cw, traj[ind:ind + s])
        vis[ind:ind + s] = torch.where(write, vw, vis[ind:ind + s])
        prev = ind
    return traj[:t], vis[:t]


def grid_points(size: int, hw) -> np.ndarray:
    """CoTracker v1's support grid: [size^2, 2] (x, y), w // 64 margin."""
    h, w = hw
    step = w // 64
    gy, gx = np.meshgrid(np.linspace(step, h - step, size),
                         np.linspace(step, w - step, size), indexing="ij")
    return np.stack([gx, gy], -1).reshape(-1, 2)


def cotracker_track(video, query_points, sd, tracker: dict, p: Precision = F32):
    """video [T, H, W, 3] uint8, query_points [N, 3] (t, x, y frame pixels)
    -> (trajectories [T, N, 2] frame pixels, visibility probabilities
    [T, N]; a point is visible above `visibility_threshold`):
    the video resized to `interp_shape` and encoded once, the support grid
    added every `support_grid_every_n_frames` frames, the windows run
    forward and over the time-flipped video, and the backward pass filling
    what the forward pass left at exactly 0."""
    t0, h, w, _ = video.shape
    ih, iw = tracker["interp_shape"]
    s, stride = tracker["s"], tracker["stride"]
    qp = np.asarray(query_points, np.float64).copy()
    n_points = qp.shape[0]
    qp[:, 1] *= iw / w
    qp[:, 2] *= ih / h
    grid = grid_points(tracker["support_grid_size"], (ih, iw))
    extra = [np.concatenate([np.full((len(grid), 1), float(i)), grid], 1)
             for i in range(0, t0, tracker["support_grid_every_n_frames"])]
    queries = np.concatenate([qp] + extra).astype(np.float32)
    fmaps = encode_video(video, sd, stride, p, (ih, iw))
    t = max(t0, s)
    if t > t0:
        fmaps_f = torch.cat([fmaps, fmaps[-1:].expand(t - t0, -1, -1, -1)])
        fmaps_b = torch.cat([fmaps.flip(0), fmaps[:1].expand(t - t0, -1, -1,
                                                               -1)])
    else:
        fmaps_f, fmaps_b = fmaps, fmaps.flip(0)
    q = torch.as_tensor(queries, device=video.device)
    q = torch.cat([q[:, :1], q[:, 1:] / stride], 1)
    traj_f, vis_f = _cotracker_pass(fmaps_f, q, t, sd, s, tracker["iters"], p)
    qb = q.clone()
    qb[:, 0] = t0 - q[:, 0] - 1
    traj_b, vis_b = _cotracker_pass(fmaps_b, qb, t, sd, s, tracker["iters"], p)
    traj_f, vis_f = traj_f[:t0] * stride, vis_f[:t0]
    traj_b, vis_b = traj_b[:t0].flip(0) * stride, vis_b[:t0].flip(0)
    zero = traj_f == 0
    traj = torch.where(zero, traj_b, traj_f)[:, :n_points]
    vis = torch.sigmoid(torch.where(zero[..., 0], vis_b, vis_f))[:, :n_points]
    traj = traj * torch.tensor([w / iw, h / ih], device=video.device)
    return traj, vis


# ----------------------------------------------------------------------------
# PIPS
# ----------------------------------------------------------------------------

PIPS = dict(hidden=512, depth=12, expansion=4)
# lucidrains' MLP-Mixer, which PIPS uses: nn.LayerNorm's default epsilon.
MIXER_EPS = 1e-5


def pips_shapes(tracker: dict) -> dict:
    s = tracker["s"]
    hid, e = PIPS["hidden"], PIPS["expansion"]
    out = encoder_shapes()
    d = "delta_block.to_delta."
    out.update(_lin_shapes(d + "0", hid, LATENT + CORR_DIM + 195))
    for k in range(1, PIPS["depth"] + 1):
        b = f"{d}{k}."
        out.update({b + "0.fn.0.weight": (s * e, s, 1), b + "0.fn.0.bias": (s * e,),
                    b + "0.fn.3.weight": (s, s * e, 1), b + "0.fn.3.bias": (s,)})
        out.update(_lin_shapes(b + "1.fn.0", hid * e, hid))
        out.update(_lin_shapes(b + "1.fn.3", hid, hid * e))
        for j in (0, 1):
            out.update({f"{b}{j}.norm.weight": (hid,),
                        f"{b}{j}.norm.bias": (hid,)})
    last = PIPS["depth"] + 1
    out.update({f"{d}{last}.weight": (hid,), f"{d}{last}.bias": (hid,)})
    out.update(_lin_shapes(f"{d}{last + 2}", s * (LATENT + 2), hid))
    out.update(_head_shapes())
    return out


def _delta_block(fhid, fcorr, flow, sd, s, p):
    """[N, S, 128], [N, S, 196], [N, S, 3] -> [N, S, 130]."""
    emb = torch.cat([sincos_interleaved(flow[..., i], 64) for i in range(3)]
                    + [flow], -1)
    d = "delta_block.to_delta."
    x = linear(torch.cat([fhid, fcorr, emb], -1), sd, d + "0", p)
    for k in range(1, PIPS["depth"] + 1):
        b = f"{d}{k}."
        y = layer_norm(x, sd, b + "0.norm", MIXER_EPS)  # token mixing over S
        w1, w2 = sd[b + "0.fn.0.weight"][..., 0], sd[b + "0.fn.3.weight"][..., 0]
        y = gelu(torch.einsum("os,nsc->noc", p(w1), p(y))
                 + sd[b + "0.fn.0.bias"].float()[None, :, None])
        y = (torch.einsum("so,noc->nsc", p(w2), p(y))
             + sd[b + "0.fn.3.bias"].float()[None, :, None])
        x = x + y
        y = layer_norm(x, sd, b + "1.norm", MIXER_EPS)  # channel mixing
        y = linear(gelu(linear(y, sd, b + "1.fn.0", p)), sd, b + "1.fn.3", p)
        x = x + y
    last = PIPS["depth"] + 1
    x = layer_norm(x, sd, f"{d}{last}", MIXER_EPS).mean(1)
    x = linear(x, sd, f"{d}{last + 2}", p)
    return x.reshape(x.shape[0], s, LATENT + 2)


def pips_window(fmaps, xys, feat_init, sd, iters, p: Precision):
    """fmaps [S, C, h, w], xys [N, 2] feature pixels at the window's frame 0,
    feat_init [N, C] -> (coords [S, N, 2] feature pixels, vis logits)."""
    s = fmaps.shape[0]
    n = xys.shape[0]
    coords = xys[None].expand(s, n, 2)
    ffeats = feat_init[None].expand(s, n, LATENT)
    times = torch.linspace(0.0, float(s), s, device=fmaps.device)
    times = times[None, :, None].expand(n, s, 1)
    for _ in range(iters):
        fcorr = corr_taps(fmaps, ffeats, coords, p)
        flow = torch.cat([(coords - coords[:1]).transpose(0, 1), times], -1)
        delta = _delta_block(ffeats.transpose(0, 1), fcorr.transpose(0, 1),
                             flow, sd, s, p)
        upd = layer_norm(delta[..., 2:], sd, "norm", 1e-5)
        upd = gelu(linear(upd, sd, "ffeat_updater.0", p))
        ffeats = ffeats + upd.transpose(0, 1)
        coords = coords + delta[..., :2].transpose(0, 1)
        coords = torch.cat([xys[None], coords[1:]])
    return coords, linear(ffeats, sd, "vis_predictor.0", p)[..., 0]


def _pips_link(fmaps, queries, sd, tracker, reverse, p):
    """PIPS's chained windows in one direction (frame i read as T-1-i when
    `reverse`): from each point's query frame a window over the next S
    frames; the point's next window starts at the latest of its frames
    whose visibility clears a threshold that falls by 0.02 while none
    does. Returns numpy traj [T, N, 2] (frame pixels), vis [T, N]."""
    s, stride, t = tracker["s"], tracker["stride"], fmaps.shape[0]
    n = queries.shape[0]
    cols = np.arange(n)
    start = queries[:, 0].astype(np.int64)
    traj = np.zeros((t, n, 2), np.float32)
    vis = np.zeros((t, n), np.float32)
    traj[start, cols] = queries[:, 1:]
    vis[start, cols] = 1.0

    def frame(i):
        return t - 1 - i if reverse else i

    grid = torch.as_tensor(queries[:, 1:] / stride, device=fmaps.device)
    feat_init = torch.stack([
        bilinear_at(fmaps[frame(int(start[i]))], grid[i:i + 1, 0],
                    grid[i:i + 1, 1])[0] for i in range(n)])
    frontier = start.copy()
    for cf in range(t - 1):
        act = np.nonzero(frontier == cf)[0]
        if not len(act):
            continue
        last = min(cf + s, t) - 1
        idx = [frame(min(cf + k, t - 1)) for k in range(s)]
        xy = torch.as_tensor(traj[cf, act], device=fmaps.device) / stride
        coords, vlog = pips_window(fmaps[idx], xy, feat_init[act], sd,
                                   tracker["iters"], p)
        coords = (coords * stride).cpu().numpy()
        v = torch.sigmoid(vlog).cpu().numpy()
        traj[cf + 1:last + 1, act] = coords[1:last + 1 - cf]
        vis[cf + 1:last + 1, act] = v[1:last + 1 - cf]
        nxt = np.full(len(act), last)
        th = np.full(len(act), tracker["initial_next_frame_visibility_threshold"],
                     np.float32)
        below = vis[nxt, act] <= th
        while below.any():
            nxt = np.where(below, nxt - 1, nxt)
            wrapped = nxt <= cf
            th = np.where(wrapped, th - np.float32(0.02), th)
            nxt = np.where(wrapped, last, nxt)
            below = vis[nxt, act] <= th
        frontier[act] = nxt
    return traj, vis


def pips_track(video, query_points, sd, tracker: dict, p: Precision = F32):
    """video [T, H, W, 3] uint8, query_points [N, 3] (t, x, y) -> (traj
    [T, N, 2] frame pixels, visibility probabilities [T, N]; a point is
    visible above 0.5): chained windows forward and over the reversed
    video, stitched at each point's query frame."""
    qp = np.asarray(query_points, np.float32)
    fmaps = encode_video(video, sd, tracker["stride"], p)
    t = fmaps.shape[0]
    traj_f, vis_f = _pips_link(fmaps, qp, sd, tracker, False, p)
    qb = qp.copy()
    qb[:, 0] = t - qp[:, 0] - 1
    traj_b, vis_b = _pips_link(fmaps, qb, sd, tracker, True, p)
    before = np.arange(t)[:, None] < qp[:, 0].astype(np.int64)[None]
    traj = np.where(before[..., None], traj_b[::-1], traj_f)
    vis = np.where(before, vis_b[::-1], vis_f)
    dev = video.device
    return torch.as_tensor(traj, device=dev), torch.as_tensor(vis, device=dev)


# name -> (checkpoint shapes, track, the visibility threshold)
TRACKERS = {
    "cotracker": (cotracker_shapes, cotracker_track,
                  lambda tracker: tracker["visibility_threshold"]),
    "pips": (pips_shapes, pips_track, lambda tracker: 0.5),
}
