"""The comparison that decides `correct`: what the timed path produced for
the cycle's first pass of videos (all of them are done in every window),
held against the plain reference recomputed from the same frames, masks
and checkpoints.

Per video, on frames drawn from the seed. Each number that a reduction
makes is taken per object slot (a video's object) and then the worst slot
is held, so that a fault in one slot of many shows:
  - query points: every point on its query frame, the positives on their
    mask and the negatives off it (exact: `query_faults`);
  - embeddings: the reference's encoder on the drawn frames, the widest
    relative L2 gap (`embed_rel_l2`);
  - tracks: the reference's tracker over the whole video from the
    program's query points (the sampler draws from the program's own
    random state), per slot the median distance of the program's points
    from the reference's over its points and every frame (`track_px`),
    and the visibilities that differ from what the program's own
    trajectories and the reference's probabilities give (outside the
    frame, or the probability against the threshold), where that
    probability is more than `vis_band` from the threshold (exact:
    `vis_flips`);
  - decode chain: every object of the drawn frames, decoded by the
    reference from its own embeddings and the program's tracks and
    visibilities (the stage above is checked by itself). The IoU gate:
    pairs kept by one side only, where the reference's IoU lies more than
    `gate_band` from the gate (exact: `gate_flips`). The IoU scores: per
    slot the median absolute gap over its pairs with a visible prompt
    (`iou_gap`), reported and not compared: the control reads it under
    three times a sound run's, so no limit holds. The logits: per slot the median over its pairs kept by
    both sides of the relative L2 gap of the frame-size logits
    (`logit_rel_l2`), the reference's rounded to float16 as SamPt keeps
    its logits. A median over a slot's pairs, not its widest: the box
    refinements threshold the mask, so one pixel's sign at the mask's edge
    moves the next box, and after 12 passes a rare pair's gap reads 10x
    the others';
  - fusion: the reference's argmax of the program's logits against the
    program's index masks, every frame (exact: `fuse_px`).
A run's `launch_faults` (videos whose kernel launches differ from the
schedule) is compared with the same limit of 0.

A control runs the same reference one precision below the configuration's
(`ops.LOWER`) in the program's place, and is compared the same way.

Every model-specific step is a call on the configuration's reference
module (`registry.Cell.reference`), passed in as `ref`; this file names
none. Embeddings may be one tensor [T, ...] or a dict of them (HQ-SAM's
{'emb', 'interm'}), compared leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference.ops import LOWER, Precision, no_tf32

NAMES = ("query_faults", "embed_rel_l2", "track_px", "vis_flips",
         "gate_flips", "logit_rel_l2", "fuse_px", "launch_faults")


def draw(seed: int, n: int, k: int) -> list:
    """`k` of range(n), drawn from the seed, sorted."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _leaves(emb) -> dict:
    """An embedding's tensors by key (one tensor: the key None)."""
    return emb if isinstance(emb, dict) else {None: emb}


def _frame(emb, i):
    """Frame `i` of embeddings [T, ...], or of each tensor of a dict."""
    if isinstance(emb, dict):
        return {key: e[i] for key, e in emb.items()}
    return emb[i]


def compare(ref, config: dict, checkpoints: dict, kept: list, seed: int,
            device) -> dict:
    """`ref`: the configuration's reference module. `kept`: per video of
    the first pass, a dict with the video ('image', 'query_masks',
    'query_point_timestep', 'target_hw'), the program's 'query_points',
    'embeddings', 'trajectories', 'visibilities', 'logits',
    'scores_per_frame' and 'masks' (index masks). Returns the worst
    reading of each number over the videos and their object slots (the
    exact ones summed)."""
    draws = config["check"]
    sd_sam = {k: v.float() for k, v in checkpoints["sam"].items()}
    sd_tr = {k: v.float() for k, v in checkpoints["tracker"].items()}
    settings = config["sam_pt"]
    n_pos = settings["positive_points_per_mask"]
    others = settings["add_other_objects_positive_points_as_negative_points"]
    gate = settings["sam_iou_threshold"]
    worst = dict.fromkeys(NAMES[:-1] + ("iou_gap",), 0.0)
    with torch.no_grad(), no_tf32():
        for v_i, k in enumerate(kept):
            video = torch.from_numpy(k["image"]).to(device)
            t = video.shape[0]
            hw = tuple(k["target_hw"])
            masks = np.asarray(k["query_masks"], np.float32)
            ts = np.asarray(k["query_point_timestep"], np.float32)
            qp = k["query_points"]
            worst["query_faults"] += ref.query_point_faults(qp, masks, ts,
                                                            n_pos)

            frames = draw(seed + v_i, t, draws["frames_per_video"])
            emb = ref.embeddings(video[frames], sd_sam, config)
            got = _leaves(k["embeddings"])
            for key, want in _leaves(emb).items():
                for j, f in enumerate(frames):
                    worst["embed_rel_l2"] = max(worst["embed_rel_l2"],
                                                _rel_l2(got[key][f], want[j]))

            traj_r, vis_r, prob_r = ref.tracks(video, qp, sd_tr, config)
            traj_p = k["trajectories"].float()
            vis_p = k["visibilities"].float()
            dist = (traj_p - traj_r).norm(dim=-1)  # [T, M, P]
            for obj in range(masks.shape[0]):
                worst["track_px"] = max(worst["track_px"],
                                        float(dist[:, obj].median()))
            want = ref.visibility(traj_p, prob_r, hw, config)
            clear = (prob_r - ref.threshold(config)).abs() > draws["vis_band"]
            worst["vis_flips"] += int(((vis_p != want) & clear).sum())

            scores_p = k["scores_per_frame"].float()
            for obj in range(masks.shape[0]):
                gaps, iou_gaps = [], []
                for j, f in enumerate(frames):
                    pts, lbl = ref.prompt(traj_p[f], vis_p[f], obj, n_pos,
                                          others)
                    logits_r, iou_r, visible = ref.decode(
                        _frame(emb, j), pts, lbl, hw, sd_sam, config)
                    iou_r, iou_p = float(iou_r), float(scores_p[f, obj])
                    if visible and np.isfinite(iou_p):
                        iou_gaps.append(abs(iou_p - iou_r))
                    # at the precision the configuration's logits are kept in
                    logits_r = logits_r.half().float()
                    logits_p = k["logits"][obj, f].float()
                    kept_p = bool(torch.isfinite(logits_p).any())
                    kept_r = visible and iou_r >= gate
                    if kept_p != kept_r:
                        # unless a gate decided on rounding
                        worst["gate_flips"] += int(
                            abs(iou_r - gate) > draws["gate_band"])
                    elif kept_p:
                        finite = torch.isfinite(logits_p)
                        gaps.append(_rel_l2(logits_p[finite], logits_r[finite]))
                if iou_gaps:
                    worst["iou_gap"] = max(worst["iou_gap"],
                                           float(np.median(iou_gaps)))
                if gaps:
                    worst["logit_rel_l2"] = max(worst["logit_rel_l2"],
                                                float(np.median(gaps)))

            fused = ref.fuse(k["logits"], torch.from_numpy(masks).to(device),
                             [int(x) for x in ts])
            worst["fuse_px"] += int((fused.cpu().numpy() != k["masks"]).sum())
            del video, emb, traj_r, vis_r
    return worst


def control_outputs(ref, config: dict, checkpoints: dict, videos: list,
                    seed: int, device) -> list:
    """The reference `ref` one precision below the configuration's, in the
    program's place, over `videos`: the fields `compare` reads, on the
    frames it draws for `seed` (the other frames' planes are gated). The
    query points are a plain sampler's (positives spread over the mask,
    the negatives off it), which the query-point check holds as it holds
    the program's."""
    p_sam = Precision(LOWER[config["sam"]["dtype"]])
    p_tr = Precision(LOWER[config["tracker"]["dtype"]])
    sd_sam = {k: v.float() for k, v in checkpoints["sam"].items()}
    sd_tr = {k: v.float() for k, v in checkpoints["tracker"].items()}
    settings = config["sam_pt"]
    n_pos = settings["positive_points_per_mask"]
    threshold = settings["sam_iou_threshold"]
    out = []
    with torch.no_grad(), no_tf32():
        for v_i, v in enumerate(videos):
            video = torch.from_numpy(v["image"]).to(device)
            t, h, w, _ = video.shape
            masks = np.asarray(v["query_masks"], np.float32)
            ts = np.asarray(v["query_point_timestep"], np.float32)
            qp = plain_query_points(masks, ts, n_pos,
                                    settings["negative_points_per_mask"])
            frames = draw(seed + v_i, t, config["check"]["frames_per_video"])
            emb = ref.video_embeddings(video, frames, sd_sam, config, p_sam)
            traj, vis, _ = ref.tracks(video, qp, sd_tr, config, p_tr)
            m = masks.shape[0]
            logits = torch.full((m, t, h, w), -torch.inf, device=device)
            spf = torch.full((t, m), -torch.inf, device=device)
            for f in frames:
                for obj in range(m):
                    pts, lbl = ref.prompt(traj[f], vis[f], obj, n_pos, settings[
                        "add_other_objects_positive_points_as_negative_points"])
                    lg, iou, visible = ref.decode(_frame(emb, f), pts, lbl,
                                                  (h, w), sd_sam, config, p_sam)
                    if not visible:
                        continue
                    spf[f, obj] = iou
                    if float(iou) >= threshold:
                        logits[obj, f] = lg
            logits = logits.half()
            fused = ref.fuse(logits, torch.from_numpy(masks).to(device),
                             [int(x) for x in ts])
            out.append(dict(v, query_points=qp, embeddings=emb,
                            trajectories=traj, visibilities=vis,
                            logits=logits, scores_per_frame=spf,
                            masks=fused.cpu().numpy()))
    return out


def plain_query_points(masks, ts, n_pos: int, n_neg: int) -> np.ndarray:
    """Positives: `n_pos` mask pixels spread evenly over the mask's pixel
    list; negatives: pixels off the mask, likewise. [M, P, 3]."""
    out = []
    for mask, t in zip(masks, ts):
        ys, xs = np.nonzero(mask > 0.5)
        on = np.linspace(0, len(ys) - 1, n_pos).astype(np.int64)
        oys, oxs = np.nonzero(mask <= 0.5)
        off = np.linspace(0, len(oys) - 1, n_neg + 2)[1:-1].astype(np.int64)
        pts = np.concatenate([np.stack([xs[on], ys[on]], 1),
                              np.stack([oxs[off], oys[off]], 1)])
        out.append(np.concatenate([np.full((len(pts), 1), t), pts], 1))
    return np.asarray(out, np.float32)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): each number at or under its
    limit."""
    rows = [(name, numbers[name], limits[name]) for name in NAMES]
    return all(v <= lim for _, v, lim in rows), rows
