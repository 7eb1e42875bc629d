"""Faults planted underneath the timed path, for the tests that see
`correct` come out false: the tracker returns its state unchanged (every
point stays at its query position); half of each decode chunk left out
(every other pair's logits and IoU stay zero, so the gate drops it); one
object slot of many wrong (the last object's points left at their query
positions; the last object's logits and scores those of the object before
it); the prompts' x and y swapped; the IoU gate dropped; an answer altered
where it is produced (one pixel of a video's index masks, one point's
visibility, one query point); on the card, a kernel taken off the path
(K1's plain version in its place). The system runs on one card,
so there is no exchange between cards to leave out. Each takes the system
adapter and returns it patched."""
import numpy as np
import torch

# The IoU head's bias the faulted runs are held at: at the configurations'
# 0.77 every drawn pair of the tests' seeds passes the gate, and a dropped
# gate would have nothing to show on.
GATE_DECIDES = {"mask_decoder.iou_prediction_head.layers.2.bias": 0.72}


def frozen_tracker(system):
    build = system.build

    def patched(config, weights, device):
        sam_pt = build(config, weights, device)

        def forward_device(rgbs, query_points):
            q = torch.as_tensor(np.asarray(query_points)[0, :, 1:],
                                device=rgbs.device)
            t = rgbs.shape[1]
            traj = q[None].expand(t, -1, -1).clone()
            return traj[None], torch.ones(traj.shape[:2],
                                          device=rgbs.device)[None]

        sam_pt.point_tracker.forward_device = forward_device
        return sam_pt

    system.build = patched
    return system


def half_decode_chunk(system):
    build = system.build

    def patched(config, weights, device):
        sam_pt = build(config, weights, device)
        chain = sam_pt._chain

        def half(emb, pts, lbl, hw):
            # every other pair is left out: its logits and IoU stay zero
            up, iou = chain(emb, pts, lbl, hw)
            up, iou = up.clone(), iou.clone()
            up[1::2] = 0
            iou[1::2] = 0
            return up, iou

        sam_pt._chain = half
        return sam_pt

    system.build = patched
    return system


def _patched(system, patch):
    """`system` whose `build` applies `patch` to the SamPt it builds."""
    build = system.build

    def patched(config, weights, device):
        sam_pt = build(config, weights, device)
        patch(sam_pt)
        return sam_pt

    system.build = patched
    return system


def last_slot_frozen(system):
    """The last object's points of every video of several objects stay at
    their query positions."""
    def patch(sam_pt):
        track = sam_pt._track_points_device

        def frozen(images_dev, query_points, hw):
            traj, vis = track(images_dev, query_points, hw)
            if traj.shape[1] > 1:
                q = torch.as_tensor(np.asarray(query_points)[-1, :, 1:],
                                    device=traj.device, dtype=traj.dtype)
                traj = traj.clone()
                traj[:, -1] = q
            return traj, vis

        sam_pt._track_points_device = frozen

    return _patched(system, patch)


def last_slot_off_by_one(system):
    """The last object's logits and scores of every video of several
    objects are those of the object before it."""
    def patch(sam_pt):
        decode = sam_pt._decode_prompts

        def shifted(hw, points, labels, embeddings):
            logits, scores = decode(hw, points, labels, embeddings)
            if logits.shape[0] > 1:
                logits, scores = logits.clone(), scores.clone()
                logits[-1] = logits[-2]
                scores[:, -1] = scores[:, -2]
            return logits, scores

        sam_pt._decode_prompts = shifted

    return _patched(system, patch)


def swapped_xy(system):
    """Every prompt point's x and y swapped before the decode chain."""
    def patch(sam_pt):
        chain = sam_pt._chain

        def swapped(emb, pts, lbl, hw):
            return chain(emb, pts.flip(-1), lbl, hw)

        sam_pt._chain = swapped

    return _patched(system, patch)


def dropped_gate(system):
    """Every pair with a visible prompt kept, whatever its IoU."""
    def patch(sam_pt):
        sam_pt.sam_iou_threshold = -float("inf")

    return _patched(system, patch)


def altered_mask(system):
    class Harness(system.Harness):
        def resolve(self):
            masks = super().resolve()
            if masks is not None:
                masks = masks.copy()
                masks[-1, -1, -1] = (masks[-1, -1, -1] + 1) % 3
            return masks

    system.Harness = Harness
    return system


def altered_visibility(system):
    """One visible point of every video reported invisible."""
    build = system.build

    def patched(config, weights, device):
        sam_pt = build(config, weights, device)
        track = sam_pt._track_points_device

        def altered(*args, **kwargs):
            traj, vis = track(*args, **kwargs)
            vis = vis.clone()
            flat = vis.view(-1)
            flat[int(torch.nonzero(flat == 1)[0])] = 0
            return traj, vis

        sam_pt._track_points_device = altered
        return sam_pt

    system.build = patched
    return system


def altered_query_point(system):
    """One positive query point of every video moved off its mask."""
    build = system.build

    def patched(config, weights, device):
        sam_pt = build(config, weights, device)
        extract = sam_pt.extract_query_points

        def altered(images, masks, timesteps):
            qp = extract(images, masks, timesteps).copy()
            ys, xs = np.nonzero(masks[0] < 0.5)
            qp[0, 0, 1:] = (xs[0], ys[0])
            return qp

        sam_pt.extract_query_points = altered
        return sam_pt

    system.build = patched
    return system


def plain_window_kernel(system):
    """K1 replaced by its plain version (not launched): on the card only."""
    kernels = system.kernel_module

    def module():
        fa = kernels()
        fa.window_attention_cuda = fa.window_attention_plain
        return fa

    system.kernel_module = module
    build = system.build

    def patched(config, weights, device):
        module()
        return build(config, weights, device)

    system.build = patched
    return system


FAULTS = [frozen_tracker, half_decode_chunk, last_slot_frozen,
          last_slot_off_by_one, swapped_xy, dropped_gate, altered_mask,
          altered_visibility, altered_query_point]
CARD_FAULTS = FAULTS + [plain_window_kernel]
