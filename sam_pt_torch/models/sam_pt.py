"""SAM-PT orchestrator (counterpart of `sam_pt_tpu/models/sam_pt.py`).

Per video: upload once; embed every frame with the batched SAM encoder
(once, for every path below; with HQ-SAM, its decoder's image-level
features too, once a frame); take query masks (sample query points from
them on the host) or query points (decode each one's query frame with SAM
into a query mask, as the JAX package does); then

  - without point re-initialisation, the device flow: track the points,
    build fixed-shape padded prompts for every (frame, object) pair on the
    device, decode all pairs in chunks through the decode chain
    (positives-only pass, all-points pass with the mask as input, then
    box-refinement passes), gate by IoU, return device tensors;
  - with it (`use_point_reinit`), the host flow of the JAX package: track
    and decode in horizon windows, re-sample each object's query points
    from its predicted mask at a frame chosen per `reinit_variant`, over
    the video and over the time-flipped video, and stitch the two at each
    object's query frame. The data-dependent control flow runs on the
    host; tracking and decoding run on the device.

A tracker that keeps per-video mask state (SuperGlue, `set_masks`) is
given the query masks before it tracks: in `forward` (with query points,
the masks SAM decodes from them), and with re-initialisation each
window's masks, decoded from the window's query points; it must track
every mask in one batch (`point_tracker_mask_batch_size`).

With `use_patch_matching_filtering`, the LAB patch similarities of every
(frame, point) pair are computed on the device in one pass and the
cascade's bookkeeping runs on the host; the prompts are then built on the
host, as on the JAX package's host path.

The box-refinement passes run unconditionally: the JAX package stops its
loop at the exact fixed point, which gives the same output, but on a GPU
that test costs a host sync per pass.

Data parallelism (`data_parallel=True`, over `mesh` or a mesh of every
rank): every rank of a `torch.distributed` world runs this same host
orchestration with the same seed; the encode and decode chunks are rounded up to multiples of the
mesh's `data` axis, and the predictor, rebuilt on the mesh, encodes and
decodes this rank's slice of each chunk and gathers the results, so every
rank holds identical bits and takes the same host decisions (gates,
k-medoids), and returns the same outputs. In one process it is a world of
one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.color import rgb_to_lab
from ..ops.resize import resize_planes
from ..ops.sampling import patch_sample
from ..utils.query_points import (
    extract_corner_points,
    extract_kmedoid_points,
    extract_mixed_points,
    extract_random_mask_points,
)
from ..parallel.mesh import batch_sharding, check_mesh, create_mesh
from ..utils import tracing
from ..utils.tree import leading_size, pad_last, tree_map
from ..utils.util import PointVisibilityType
from .sam.encode_graphs import EncodeGraphs
from .sam.predictor import SamPredictor
from .tracker.api import PointTracker

NEG_INF = -float("inf")


def build_prompts(traj: torch.Tensor, vis: torch.Tensor, n_pos: int,
                  has_neg: bool, add_other: bool):
    """traj [T, M, P, 2], vis [T, M, P] -> points [T, M, N, 2], labels
    [T, M, N] (1 positive, 0 negative, -1 pad), on the device. With
    `add_other`, every other object's positives join as negatives (pad when
    invisible), each in its own slot (`SamPt._build_prompts` compacts them
    on the host instead; the decoder reads the same token set)."""
    t, m, p, _ = traj.shape
    device = traj.device
    visible = vis == 1
    base = torch.ones(p, dtype=torch.long, device=device)
    if has_neg:
        base[n_pos:] = 0
    labels = torch.where(visible, base, torch.full_like(base, -1))
    points = traj.float()
    if add_other and m > 1:
        oidx = torch.as_tensor(
            [[o for o in range(m) if o != mi] for mi in range(m)],
            device=device)  # [M, M-1]
        opts = points[:, :, :n_pos][:, oidx]  # [T, M, M-1, n_pos, 2]
        ovis = visible[:, :, :n_pos][:, oidx]
        points = torch.cat([points, opts.reshape(t, m, -1, 2)], dim=2)
        other = torch.where(ovis, 0, -1).reshape(t, m, -1)
        labels = torch.cat([labels, other], dim=2)
    return points, labels


def patch_similarities(images: torch.Tensor, flat_traj: torch.Tensor,
                       query_points: torch.Tensor,
                       patch_size: int) -> torch.Tensor:
    """images [T, H, W, 3] uint8, flat_traj [T, N, 2], query_points [N, 3]
    (t, x, y) -> similarities [T, N] float32, on the images' device: the
    LAB patch around each point's position on every frame against its patch
    on its own query frame, exp(-||diff|| / (2 patch_size^2)). As the
    reference does (sam_pt.py:645), the frames are read as BGR."""
    lab = rgb_to_lab(images.flip(-1))
    patches = patch_sample(lab, flat_traj, patch_size)  # [T, N, K*K, 3]
    frames = query_points[:, 0].long()
    templates = patch_sample(lab[frames], query_points[:, None, 1:],
                             patch_size)[:, 0]  # [N, K*K, 3]
    diff = (patches - templates[None]).flatten(2)
    return torch.exp(-diff.norm(dim=-1) / (2 * patch_size ** 2))


class SamPt:
    def __init__(
        self,
        point_tracker: PointTracker,
        sam_predictor: SamPredictor,
        sam_iou_threshold: float = 0.7,
        positive_point_selection_method: str = "kmedoids",
        negative_point_selection_method: str = "mixed",
        positive_points_per_mask: int = 8,
        negative_points_per_mask: int = 1,
        add_other_objects_positive_points_as_negative_points: bool = False,
        max_other_objects_positive_points: Optional[int] = None,
        point_tracker_mask_batch_size: int = 5,
        iterative_refinement_iterations: int = 0,
        use_patch_matching_filtering: bool = False,
        patch_size: int = 3,
        patch_similarity_threshold: float = 0.01,
        use_point_reinit: bool = False,
        reinit_point_tracker_horizon: int = 24,
        reinit_horizon: int = 24,
        reinit_variant: str = "reinit-at-median-of-area-diff",
        fail_on_empty_reinit_mask: bool = False,
        sam_decode_chunk: int = 32,
        sam_encode_chunk: int = 4,
        seed: int = 72,
        data_parallel: bool = False,
        mesh=None,
        logits_dtype: torch.dtype = torch.float16,
    ):
        check_mesh(mesh)
        if reinit_point_tracker_horizon < reinit_horizon:
            raise ValueError("reinit_point_tracker_horizon must be at least "
                             "reinit_horizon")
        self.point_tracker = point_tracker
        self.sam_predictor = sam_predictor
        self.sam_iou_threshold = sam_iou_threshold
        self.positive_point_selection_method = positive_point_selection_method
        self.negative_point_selection_method = negative_point_selection_method
        self.positive_points_per_mask = positive_points_per_mask
        self.negative_points_per_mask = negative_points_per_mask
        self.add_other_objects_positive_points_as_negative_points = (
            add_other_objects_positive_points_as_negative_points)
        self.max_other_objects_positive_points = max_other_objects_positive_points
        self.point_tracker_mask_batch_size = point_tracker_mask_batch_size
        self.iterative_refinement_iterations = iterative_refinement_iterations
        self.use_patch_matching_filtering = use_patch_matching_filtering
        self.patch_size = patch_size
        self.patch_similarity_threshold = patch_similarity_threshold
        self.use_point_reinit = use_point_reinit
        self.reinit_point_tracker_horizon = reinit_point_tracker_horizon
        self.reinit_horizon = reinit_horizon
        self.reinit_variant = reinit_variant
        self.fail_on_empty_reinit_mask = fail_on_empty_reinit_mask
        self.sam_decode_chunk = sam_decode_chunk
        self.sam_encode_chunk = sam_encode_chunk
        # `data_parallel` wires `mesh` (or a mesh of every rank) at the
        # first forward (`_setup_mesh`); `mesh` alone is not used, as in
        # the JAX package.
        self.data_parallel = data_parallel
        self.mesh = mesh
        self._data_sharding = None
        self.logits_dtype = logits_dtype
        # The video path's encode chunks, one CUDA graph a shape
        # (`_encode_all_frames`); None encodes eagerly.
        self.encode_graphs: Optional[EncodeGraphs] = EncodeGraphs()
        self.rng = np.random.default_rng(seed)
        # (direction, start, end, tracked masks) of every horizon window the
        # last re-initialising forward decoded, for inspection.
        self.reinit_windows: List[Tuple[str, int, int, int]] = []

    @property
    def device(self) -> torch.device:
        return self.sam_predictor.model.device

    # ------------------------------------------------------------------
    # Data parallelism over a mesh of ranks
    # ------------------------------------------------------------------
    def _setup_mesh(self) -> None:
        """Wire the mesh once: round the encode and decode chunks up to
        multiples of its `data` axis and rebuild the predictor on it."""
        if not self.data_parallel or self._data_sharding is not None:
            return
        self.mesh = self.mesh if self.mesh is not None else create_mesh()
        n = self.mesh.axis_size("data")
        self.sam_encode_chunk = -(-self.sam_encode_chunk // n) * n
        self.sam_decode_chunk = -(-self.sam_decode_chunk // n) * n
        pred = self.sam_predictor
        if pred.mesh is None:
            self.sam_predictor = SamPredictor(pred.model,
                                              antialias=pred.antialias,
                                              mesh=self.mesh)
        self._data_sharding = batch_sharding(self.mesh)

    def _replicated(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's `x` on every rank of the data axis: the tracker runs
        on every rank, and its outputs drive host decisions that must
        agree even where the ranks' devices round differently."""
        if self._data_sharding is None:
            return x
        return self._data_sharding.gather(x[None])[0]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, video: Dict) -> Dict:
        """video: 'image' [T, H, W, 3] (or [T, 3, H, W]) uint8 numpy,
        'target_hw' (h, w), and either 'query_masks' [M, H, W] with
        'query_point_timestep' [M], or 'query_points' [M, P, 3] (t, x, y).

        Returns device tensors: logits [M, T, h, w] float16 (-inf planes
        where a pair was gated or never decoded), scores [M],
        scores_per_frame [T, M], trajectories [T, M, P, 2] and
        visibilities [T, M, P].
        """
        images = np.asarray(video["image"])
        if images.ndim == 4 and images.shape[1] == 3 and images.shape[-1] != 3:
            images = np.ascontiguousarray(images.transpose(0, 2, 3, 1))
        if images.dtype != np.uint8:
            raise ValueError("input images must be uint8 (0-255)")
        with tracing.video(video.get("video_id"), self.device,
                           frames=images.shape[0]):
            return self._forward(video, images)

    def _forward(self, video: Dict, images: np.ndarray) -> Dict:
        t, h, w, _ = images.shape
        self._setup_mesh()
        with tracing.span("upload", bytes=images.nbytes):
            images_dev = torch.from_numpy(images).to(self.device)
        emb = self._embed(images_dev)

        if video.get("query_masks") is not None:
            if video.get("query_points") is not None:
                raise ValueError("give query masks or query points, not both")
            query_masks = np.asarray(video["query_masks"], np.float32)
            timesteps = np.asarray(video["query_point_timestep"], np.float32)
            query_points = self.extract_query_points(images, query_masks,
                                                     timesteps)
        elif video.get("query_points") is not None:
            query_points = np.asarray(video["query_points"], np.float32)
            query_masks = self.extract_query_masks(images, query_points, emb)
        else:
            raise ValueError("no query points or masks given")
        n_masks, n_points, _ = query_points.shape
        tracing.count("objects", n_masks)
        tracing.count("pairs", t * n_masks)
        if hasattr(self.point_tracker, "set_masks"):
            self._set_tracker_masks(query_masks, n_masks)

        if self.use_point_reinit:
            host = self._forward_w_reinit(images, images_dev, emb,
                                          query_points)
            trajectories, visibilities, logits, scores, scores_per_frame = (
                torch.from_numpy(a).to(self.device) for a in host)
        else:
            trajectories, visibilities = self._track_points_device(
                images_dev, query_points, (h, w))
            logits, scores_per_frame = self._apply_sam_device(
                (h, w), trajectories, visibilities, emb)
            scores = scores_per_frame.mean(dim=0)

        target_hw = tuple(video["target_hw"])
        if (h, w) != target_hw:
            # Whole-plane -inf sentinels would turn to NaN in the resize (a
            # zero tap weight times inf): clamp for it, then restore them.
            blank = torch.isneginf(logits).all(dim=-1).all(dim=-1)
            clamped = torch.clamp(logits, min=-30000.0)
            logits = resize_planes(clamped, target_hw)
            logits = torch.where(blank[..., None, None],
                                 torch.full_like(logits, NEG_INF), logits)
        resize = torch.tensor([target_hw[1] / w, target_hw[0] / h],
                              device=trajectories.device)
        trajectories = trajectories * resize
        assert trajectories.shape == (t, n_masks, n_points, 2)
        return {
            "logits": logits.to(torch.float16),
            "scores": scores,
            "scores_per_frame": scores_per_frame,
            "trajectories": trajectories,
            "visibilities": visibilities,
        }

    def _set_tracker_masks(self, masks: np.ndarray, n_masks: int) -> None:
        """Give a tracker that keeps per-video mask state (SuperGlue's
        `set_masks`) the query masks [m, H, W] of its next forward. It
        must track every mask in one batch: the mask batch must cover all
        `n_masks` of the video."""
        if self.point_tracker_mask_batch_size < n_masks:
            raise ValueError(
                f"point_tracker_mask_batch_size "
                f"({self.point_tracker_mask_batch_size}) must cover all "
                f"{n_masks} masks for {type(self.point_tracker).__name__}, "
                f"which keeps the masks of one forward")
        self.point_tracker.set_masks(masks)

    # ------------------------------------------------------------------
    def extract_query_points(self, images: np.ndarray,
                             query_masks: np.ndarray,
                             timesteps: np.ndarray) -> np.ndarray:
        """(t, x, y) query points [M, P, 3] sampled on the host."""
        with tracing.span("query", objects=len(query_masks)):
            pos = self._select_points(images, query_masks, timesteps,
                                      self.positive_point_selection_method,
                                      self.positive_points_per_mask)
            if self.negative_points_per_mask > 0:
                neg = self._select_points(
                    images, 1.0 - query_masks, timesteps,
                    self.negative_point_selection_method,
                    self.negative_points_per_mask)
                xy = [np.concatenate([p, n], axis=0)
                      for p, n in zip(pos, neg)]
            else:
                xy = pos
        xy = np.stack(xy, axis=0)
        ts = np.broadcast_to(timesteps[:, None, None], (*xy.shape[:2], 1))
        return np.concatenate([ts, xy], axis=2).astype(np.float32)

    def _select_points(self, images, masks, timesteps, method,
                       n) -> List[np.ndarray]:
        """`n` points a mask by `method`, each mask's in its own span (the
        mixed method's, which draws for every mask at once, in one)."""
        if method == "mixed":
            with tracing.span("query.points", points=n * len(masks)):
                return extract_mixed_points(list(masks), timesteps, images,
                                            n, rng=self.rng)
        if method == "kmedoids":
            def pick(m, _):
                return extract_kmedoid_points(m, n, rng=self.rng)
        elif method == "shi-tomasi":
            def pick(m, t):
                return extract_corner_points(images[int(t)], m, n,
                                             rng=self.rng)
        elif method == "random":
            def pick(m, _):
                return extract_random_mask_points(m, n, rng=self.rng)
        else:
            raise NotImplementedError(f"Point selection method {method}")
        points = []
        for m, t in zip(masks, timesteps):
            with tracing.span("query.points", points=n):
                points.append(pick(m, t))
        return points

    def _embed(self, images_dev: torch.Tensor):
        """[T, H, W, 3] uint8 -> every frame's embedding as the decoder
        takes it (`SamPredictor.decode_ready`): `_encode_all_frames`, and
        with HQ-SAM `_hq_features_device` after it."""
        emb = self._encode_all_frames(images_dev)
        if self.sam_predictor.model.use_hq:
            emb = self._hq_features_device(emb)
        return emb

    def _frame_chunks(self, fn, frames):
        """`fn(chunk, n)` over `frames` [T, ...] (a tensor or a dict of
        them) in chunks of `sam_encode_chunk`, the last padded with its
        final frame; `fn` returns its chunk's first `n` results, which are
        copied into the [T, ...] results before the next chunk runs (so
        they may be a graph's static outputs)."""
        ec = self.sam_encode_chunk
        t = leading_size(frames)
        out = None
        for i in range(0, t, ec):
            chunk = tree_map(lambda e: e[i:i + ec], frames)
            n = leading_size(chunk)
            res = fn(pad_last(chunk, ec), n)
            if out is None:
                out = tree_map(lambda r: r.new_empty((t, *r.shape[1:])), res)
            tree_map(lambda o, r: o[i:i + n].copy_(r), out, res)
        return out

    def _encode_all_frames(self, images_dev: torch.Tensor):
        """[T, H, W, 3] uint8 -> [T, g, g, 256] (with HQ-SAM, the
        encoder's {'emb', 'interm'} of such), in chunks of
        `sam_encode_chunk` frames. On CUDA each chunk, from the uint8
        frames to the embeddings, is the replay of one CUDA graph
        (`encode_graphs`, captured at the first chunk of a shape), so the
        device never waits on the host inside the encoder and the host's
        next work (query sampling) runs while it encodes; so does
        `SamPtInteractive`'s. Eager: a predictor on a mesh (data or tensor
        parallel), and the encoder's other callers (the automatic mask
        generator, the VOS one-point query), whose shapes come once."""
        t, h, w, _ = images_dev.shape
        ec = self.sam_encode_chunk

        def encode(chunk, n):
            with tracing.span("encode.chunk", frames=n, padded_frames=ec - n):
                emb = self.sam_predictor.encode_frames(
                    chunk, (h, w), graphs=self.encode_graphs)
                emb = tree_map(lambda e: e[:n], emb)
                if self.sam_predictor.model.use_hq:
                    tracing.count("interm_bytes", emb["interm"].nbytes)
            return emb

        with tracing.span("encode", frames=t):
            return self._frame_chunks(encode, images_dev)

    def _hq_features_device(self, embeddings: dict) -> dict:
        """HQ-SAM's {'emb', 'interm'} embeddings [T, ...] -> {'emb', 'hq'}:
        the decoder's image-level features [T, 4g, 4g, 32], computed once
        a frame (as the published decoder does once an image) in chunks
        of `sam_encode_chunk` frames, in place of the early features,
        which are then released. The decode chain gathers them per
        pair."""
        with tracing.span("hq", frames=leading_size(embeddings)):
            hq = self._frame_chunks(
                lambda chunk, n: self.sam_predictor.hq_features(chunk)[:n],
                embeddings)
            tracing.count("bytes", hq.nbytes)
        return {"emb": embeddings["emb"], "hq": hq}

    def _track_points_device(self, images_dev, query_points, hw):
        """Track in mask batches; with `use_patch_matching_filtering`, the
        patch filter; then mark points near the border OUTSIDE_FRAME.
        Returns trajectories [T, M, P, 2], visibilities [T, M, P]."""
        h, w = hw
        t = images_dev.shape[0]
        m, p, _ = query_points.shape
        bs = self.point_tracker_mask_batch_size
        with tracing.span("track", frames=t, tracks=m * p):
            video_b = images_dev[None]  # one object: the tracker's cache hits
            trajs, viss = [], []
            for i in range(0, m, bs):
                batch = query_points[i:i + bs].reshape(1, -1, 3)
                out_t, out_v = self.point_tracker.forward_device(video_b,
                                                                 batch)
                nb = min(bs, m - i)
                trajs.append(out_t[0].reshape(t, nb, p, 2))
                viss.append(out_v[0].reshape(t, nb, p))
            trajectories = torch.cat(trajs, dim=1).float()
            visibilities = torch.cat(viss, dim=1).float()
            if self.use_patch_matching_filtering:
                visibilities = self._patch_filter(images_dev, query_points,
                                                  trajectories, visibilities)
            x, y = trajectories[..., 0], trajectories[..., 1]
            oob = ((x / w < 0.01) | (x / w > 0.99) | (y / h < 0.01)
                   | (y / h > 0.99))
            visibilities = torch.where(
                oob, torch.full_like(visibilities,
                                     float(PointVisibilityType.OUTSIDE_FRAME)),
                visibilities)
            return (self._replicated(trajectories),
                    self._replicated(visibilities))

    def _patch_filter(self, images_dev, query_points, trajectories,
                      visibilities):
        """LAB patch-similarity filtering (JAX `SamPt._patch_filter`): the
        similarities of every (frame, point) pair in one pass on the device;
        the cascade's bookkeeping ([T, M*P]) on the host. A visible point
        whose patch is not similar to its query-frame patch becomes
        PATCH_NON_SIMILAR; every frame after the first such frame past the
        query frame, and before the last such frame ahead of it, becomes
        REJECTED_AFTER_PATCH_WAS_NON_SIMILAR."""
        t, m, p, _ = trajectories.shape
        qp = query_points.reshape(m * p, 3)
        sims = tracing.to_host(patch_similarities(
            images_dev, trajectories.reshape(t, m * p, 2),
            torch.from_numpy(np.ascontiguousarray(qp)).to(images_dev.device),
            self.patch_size))
        similar = sims > self.patch_similarity_threshold
        vis = tracing.to_host(visibilities.reshape(t, m * p)).copy()
        non_similar = float(PointVisibilityType.PATCH_NON_SIMILAR)
        vis[(vis == 1) & ~similar] = non_similar

        qts = qp[:, 0].astype(np.int64)
        tgrid = np.arange(t)[:, None]
        bad = vis == non_similar
        after = bad & (tgrid > qts[None, :])
        first_after = np.where(after.any(0), np.argmax(after, axis=0), t + 1)
        before = bad & (tgrid < qts[None, :])
        last_before = np.where(before.any(0),
                               t - 1 - np.argmax(before[::-1], axis=0), -1)
        reject = (tgrid > first_after[None, :]) | (tgrid < last_before[None, :])
        vis = np.where(reject, float(
            PointVisibilityType.REJECTED_AFTER_PATCH_WAS_NON_SIMILAR), vis)
        return torch.from_numpy(vis.reshape(t, m, p).astype(np.float32)).to(
            visibilities.device)

    def _apply_sam_device(self, hw, trajectories, visibilities, embeddings):
        """Prompts, decode chain, IoU gating and scores for every (frame,
        mask) pair of device trajectories. Prompts are built on the device,
        or on the host, as the JAX package's host path does, with patch
        filtering or where a cap on other objects' points draws from
        `self.rng`. Returns (logits [M, T, h, w], scores_per_frame [T, M])."""
        t, m = visibilities.shape[:2]
        with tracing.span("decode", pairs=t * m):
            if self.use_patch_matching_filtering or (
                    self.add_other_objects_positive_points_as_negative_points
                    and self.max_other_objects_positive_points is not None):
                points, labels = (
                    torch.from_numpy(a).to(trajectories.device)
                    for a in self._build_prompts(
                        tracing.to_host(trajectories),
                        tracing.to_host(visibilities)))
            else:
                points, labels = build_prompts(
                    trajectories, visibilities, self.positive_points_per_mask,
                    self.negative_points_per_mask > 0,
                    self.add_other_objects_positive_points_as_negative_points)
            return self._decode_prompts(hw, points, labels, embeddings)

    def _decode_prompts(self, hw, points, labels, embeddings):
        """points [T, M, N, 2], labels [T, M, N] on the device, embeddings
        [T, g, g, 256] -> (logits [M, T, h, w] in `logits_dtype`, -inf
        planes where the IoU gate failed or no prompt was visible;
        scores_per_frame [T, M], -inf where no prompt was visible)."""
        h, w = hw
        t, m, n_prompt = labels.shape
        pts_flat = points.reshape(t * m, n_prompt, 2)
        lbl_flat = labels.reshape(t * m, n_prompt)
        emb_flat = torch.arange(t, device=points.device).repeat_interleave(m)
        has_visible = (lbl_flat != -1).any(dim=1)

        logits, iou_all = self._decode_all_pairs(embeddings, emb_flat,
                                                 pts_flat, lbl_flat, hw)
        passed = has_visible & (iou_all >= self.sam_iou_threshold)
        logits = self._gate_logits(logits, passed, t, m, h, w)
        scores_per_frame = torch.where(
            has_visible, iou_all,
            torch.full_like(iou_all, NEG_INF)).reshape(t, m)
        return logits, scores_per_frame

    def _decode_all_pairs(self, embeddings, emb_flat, pts_flat, lbl_flat,
                          hw, chain=None):
        """Chunked decode chain (`self._chain`, or `chain`) over all pairs,
        a `decode.chunk` span each; the last chunk is padded to the full
        chunk size with copies of its first pair."""
        chain = chain or self._chain
        b = pts_flat.shape[0]
        chunk = min(self.sam_decode_chunk, b)
        if self._data_sharding is not None:
            n = self._data_sharding.size
            chunk = min(self.sam_decode_chunk, -(-b // n) * n)
        device = pts_flat.device
        ups, ious = [], []
        for i in range(0, b, chunk):
            stop = min(i + chunk, b)
            nb = stop - i
            idx = torch.cat([torch.arange(i, stop, device=device),
                             torch.full((chunk - nb,), i, device=device)])
            emb = tree_map(lambda e: e[emb_flat[idx]], embeddings)
            # The chain's decoder calls count themselves (`passes`).
            with tracing.span("decode.chunk", pairs=nb,
                              padded_pairs=chunk - nb):
                if self.sam_predictor.model.use_hq:
                    tracing.count("hq_pairs", nb)
                up, iou = chain(emb, pts_flat[idx], lbl_flat[idx], hw)
            ups.append(up[:nb])
            ious.append(iou[:nb])
        return torch.cat(ups, dim=0), torch.cat(ious, dim=0)

    def _chain(self, emb, pts, lbl, hw):
        """The decode chain for one chunk of pairs -> (upscaled logits
        [B, h, w] in `logits_dtype`, iou [B])."""
        predictor = self.sam_predictor
        pts_model = predictor.scale_coords(pts, hw)
        if self.negative_points_per_mask > 0:
            pos_lbl = torch.where(lbl == 1, lbl, torch.full_like(lbl, -1))
            masks1, _ = predictor.decode(emb, pts_model, pos_lbl,
                                         only_token0=True)
            masks, iou = predictor.decode(emb, pts_model, lbl,
                                          masks1[:, 0, :, :, None],
                                          only_token0=True)
        else:
            masks, iou = predictor.decode(emb, pts_model, lbl,
                                          only_token0=True)
        low, iou = masks[:, 0], iou[:, 0]
        for _ in range(self.iterative_refinement_iterations):
            low, iou = self._box_refine(emb, pts_model, lbl, low, iou, hw)
        up = predictor.upscale_logits(low, hw)
        return up.to(self.logits_dtype), iou

    def _box_refine(self, emb, pts_model, lbl, low, iou, hw):
        """One box-refinement pass: the box is the extent of the full-res
        mask (logits > 0), passed as raw original-pixel corner coordinates
        (as the reference does); pairs whose mask has < 2 pixels keep their
        previous result."""
        predictor = self.sam_predictor
        mask = predictor.upscale_logits(low, hw) > 0  # [B, H, W]
        h, w = mask.shape[1], mask.shape[2]
        active = mask.sum(dim=(1, 2)) >= 2
        ys = torch.arange(h, dtype=torch.float32, device=mask.device)
        xs = torch.arange(w, dtype=torch.float32, device=mask.device)
        big = 1e9
        y_any = mask.any(dim=2)
        x_any = mask.any(dim=1)
        ymin = torch.where(y_any, ys, big).amin(dim=1)
        ymax = torch.where(y_any, ys, -big).amax(dim=1)
        xmin = torch.where(x_any, xs, big).amin(dim=1)
        xmax = torch.where(x_any, xs, -big).amax(dim=1)
        corners = torch.stack([xmin, ymin, xmax, ymax], dim=1).reshape(-1, 2, 2)
        corner_lbl = torch.where(
            active[:, None], torch.tensor([2, 3], device=lbl.device),
            torch.tensor(-1, device=lbl.device)).to(lbl.dtype)
        masks, new_iou = predictor.decode(
            emb, torch.cat([pts_model, corners], dim=1),
            torch.cat([lbl, corner_lbl], dim=1), low[..., None],
            torch.ones(low.shape[0], dtype=torch.bool, device=low.device),
            only_token0=True)
        low = torch.where(active[:, None, None], masks[:, 0], low)
        iou = torch.where(active, new_iou[:, 0], iou)
        return low, iou

    @staticmethod
    def _gate_logits(logits, passed, t, m, h, w):
        """-inf planes for failed pairs; layout [M, T, h, w]."""
        logits = torch.where(passed[:, None, None], logits,
                             torch.full_like(logits, NEG_INF))
        return logits.reshape(t, m, h, w).permute(1, 0, 2, 3)

    # ------------------------------------------------------------------
    # Query masks from query points, and the host flow of the reinit path
    # ------------------------------------------------------------------
    def extract_query_masks(self, images: np.ndarray,
                            query_points: np.ndarray,
                            embeddings) -> np.ndarray:
        """Query masks [M, H, W] float32 from query points [M, P, 3]: SAM
        decodes each mask's query frame from its points, reusing that
        frame's embedding (`embeddings` [T, g, g, 256] of `images`)."""
        qidx = torch.as_tensor(query_points[:, 0, 0].astype(np.int64),
                               device=self.device)
        # each mask's query frame is its own "frame", with one mask on it
        traj = query_points[:, None, :, 1:]  # [frames=M, masks=1, P, 2]
        vis = np.ones(traj.shape[:-1], np.float32)
        logits, _ = self._apply_sam(traj, vis,
                                    tree_map(lambda e: e[qidx], embeddings),
                                    images.shape[1:3])
        threshold = self.sam_predictor.model.mask_threshold
        return (logits[0] > threshold).astype(np.float32)

    def _track_points(self, images_dev, query_points):
        """`_track_points_device` downloaded: numpy trajectories [T, M, P, 2]
        and visibilities [T, M, P] float32."""
        trajectories, visibilities = self._track_points_device(
            images_dev, query_points, tuple(images_dev.shape[1:3]))
        return trajectories.cpu().numpy(), visibilities.cpu().numpy()

    def _build_prompts(self, trajectories: np.ndarray,
                       visibilities: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Host prompts: trajectories [T, M, P, 2], visibilities [T, M, P]
        -> points [T, M, N, 2] float32, labels [T, M, N] int64, with the
        visible positives of other objects compacted to the front of their
        slots and, past `max_other_objects_positive_points`, subsampled
        with `self.rng`."""
        t, m, p, _ = trajectories.shape
        n_pos = self.positive_points_per_mask
        visible = visibilities == 1

        base = np.ones((p,), np.int64)
        if self.negative_points_per_mask > 0:
            base[n_pos:] = 0
        labels = np.where(visible, base[None, None, :], -1).astype(np.int64)
        points = trajectories.copy()

        if m > 1 and self.add_other_objects_positive_points_as_negative_points:
            cap = self.max_other_objects_positive_points
            other_slots = (m - 1) * n_pos if cap is None else cap
            opts = np.zeros((t, m, other_slots, 2), np.float32)
            olbl = np.full((t, m, other_slots), -1, np.int64)
            pos_traj = trajectories[:, :, :n_pos, :]
            pos_vis = visible[:, :, :n_pos]
            for mi in range(m):
                others = [o for o in range(m) if o != mi]
                coords = pos_traj[:, others].reshape(t, -1, 2)
                vis = pos_vis[:, others].reshape(t, -1)
                for fi in range(t):
                    vc = coords[fi][vis[fi]]
                    if cap is not None and len(vc) > cap:
                        idx = self.rng.choice(len(vc), cap, replace=False)
                        vc = vc[idx]
                    k = min(len(vc), other_slots)
                    opts[fi, mi, :k] = vc[:k]
                    olbl[fi, mi, :k] = 0
            points = np.concatenate([points, opts], axis=2)
            labels = np.concatenate([labels, olbl], axis=2)
        return points.astype(np.float32), labels

    def _apply_sam(self, trajectories: np.ndarray, visibilities: np.ndarray,
                   embeddings, hw: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Every (frame, mask) pair of host trajectories, decoded against
        the frames' `embeddings` [T, g, g, 256] on the device, with host
        prompts. Returns logits [M, T, h, w] and scores_per_frame [T, M],
        numpy float32."""
        points, labels = (torch.from_numpy(a).to(self.device)
                          for a in self._build_prompts(trajectories,
                                                       visibilities))
        logits, scores_per_frame = self._decode_prompts(hw, points, labels,
                                                        embeddings)
        return logits.float().cpu().numpy(), scores_per_frame.cpu().numpy()

    def _forward_w_reinit(self, images, images_dev, embeddings,
                          query_points):
        """Point re-initialisation in both temporal directions: the
        horizon-windowed pass over the video and over the time-flipped
        video (the encoded frames flipped with it), stitched at each mask's
        query frame. Returns numpy (trajectories, visibilities, logits
        [M, T, H, W], scores, scores_per_frame)."""
        self.reinit_windows = []
        t = images.shape[0]
        qts = query_points[:, 0, 0].astype(np.int64)
        traj_r, vis_r, logits_r, spf_r = self._forward_w_reinit_inner(
            images, images_dev, embeddings, query_points, "forward")
        if (qts == 0).all():
            # Every query starts at frame 0: the backward stitch prefix is
            # empty, so the flipped pass would be discarded whole.
            with np.errstate(invalid="ignore"):
                scores = np.nanmean(spf_r, axis=0)
            return traj_r, vis_r, logits_r, scores, spf_r

        qp_flipped = query_points.copy()
        qp_flipped[:, :, 0] = t - query_points[:, :, 0] - 1
        # torch has no negative strides: the flips are copies.
        traj_l, vis_l, logits_l, spf_l = self._forward_w_reinit_inner(
            images[::-1].copy(), torch.flip(images_dev, [0]),
            tree_map(lambda e: torch.flip(e, [0]), embeddings), qp_flipped,
            "backward")
        traj_l, vis_l, logits_l = traj_l[::-1], vis_l[::-1], logits_l[:, ::-1]
        # As in the JAX package and the reference: the backward pass's
        # scores_per_frame is stitched without being flipped back.
        trajectories, visibilities = traj_r.copy(), vis_r.copy()
        logits, spf = logits_r.copy(), spf_r.copy()
        before = np.arange(t)[:, None] < qts[None, :]  # [T, M]
        trajectories[before] = traj_l[before]
        visibilities[before] = vis_l[before]
        logits[before.T] = logits_l[before.T]
        spf[before] = spf_l[before]
        with np.errstate(invalid="ignore"):
            scores = np.nanmean(spf, axis=0)
        return trajectories, visibilities, logits, scores, spf

    def _forward_w_reinit_inner(self, images, images_dev, embeddings,
                                query_points, direction: str):
        """One temporal direction: track each mask from its query frame for
        `reinit_point_tracker_horizon` frames, decode the first
        `reinit_horizon` of them, and re-sample its query points from the
        predicted mask of a frame `_choose_reinit_timestep` picks; repeat
        from there. Embeddings are computed once and sliced per window.
        REINIT_FAILED is set only on the masks whose re-initialisation
        failed (`fail_on_empty_reinit_mask`). Returns numpy (trajectories,
        visibilities, logits [M, T, H, W], scores_per_frame)."""
        t, h, w, _ = images.shape
        m, p, _ = query_points.shape
        trajectories = np.full((t, m, p, 2), np.nan, np.float32)
        visibilities = np.zeros((t, m, p), np.float32)
        scores_per_frame = np.full((t, m), np.nan, np.float32)
        logits = np.full((m, t, h, w), np.nan, np.float32)

        current_qp = query_points.copy()
        for start in range(int(query_points[:, 0, 0].min()), t):
            end = min(start + self.reinit_horizon, t)
            end_tracker = min(start + self.reinit_point_tracker_horizon, t)
            current_ts = current_qp[:, 0, 0].astype(np.int64)
            tracked = current_ts == start
            if not tracked.any():
                continue
            qp_i = current_qp[tracked].copy()
            qp_i[:, :, 0] -= start

            if hasattr(self.point_tracker, "set_masks"):
                self._set_tracker_masks(self.extract_query_masks(
                    images[start:end_tracker], qp_i,
                    tree_map(lambda e: e[start:end_tracker], embeddings)), m)
            traj_i, vis_i = self._track_points(
                images_dev[start:end_tracker], qp_i)
            traj_i = traj_i[:end - start]
            vis_i = vis_i[:end - start]
            logits_i, spf_i = self._apply_sam(
                traj_i, vis_i, tree_map(lambda e: e[start:end], embeddings),
                (h, w))
            self.reinit_windows.append(
                (direction, start, end, int(tracked.sum())))
            pred_masks_i = logits_i > 0  # [m_i, end - start, h, w]

            logits[tracked, start:end] = logits_i
            trajectories[start:end, tracked] = traj_i
            visibilities[start:end, tracked] = vis_i
            scores_per_frame[start:end, tracked] = spf_i
            if end == t:
                continue

            # mask areas per window frame (excluding the start frame)
            area = pred_masks_i[:, 1:].sum(axis=(2, 3)).astype(np.float64)
            area[area <= 25] = np.nan
            if self.reinit_horizon // 4 < area.shape[1]:
                area[:, :self.reinit_horizon // 4] = np.nan
            next_ts = self._choose_reinit_timestep(area, pred_masks_i,
                                                   current_ts, start)
            # A NaN chosen area means every candidate mask was empty or
            # tiny. By default the points are re-sampled from it anyway
            # (the samplers return zeros), as the reference does;
            # `fail_on_empty_reinit_mask` marks the mask failed instead.
            if self.fail_on_empty_reinit_mask:
                with np.errstate(invalid="ignore"):
                    chosen = area[np.arange(len(next_ts)), next_ts]
                invalid = np.nan_to_num(chosen, nan=0.0) <= 0
            else:
                invalid = np.zeros(len(next_ts), bool)

            tracked_idx = np.nonzero(tracked)[0]
            if (~invalid).any():
                q_masks = pred_masks_i[:, 1:][
                    np.arange(len(next_ts)), next_ts].astype(np.float32)
                qp_update = self.extract_query_points(
                    images[start + 1:end], q_masks[~invalid],
                    next_ts[~invalid].astype(np.float32))
                valid_idx = tracked_idx[~invalid]
                current_qp[valid_idx] = qp_update
                current_qp[valid_idx, :, 0] += start + 1
            if invalid.any():
                inv_idx = tracked_idx[invalid]
                current_qp[inv_idx, :, 0] = t  # never tracked again
                current_qp[inv_idx, :, 1:] = 0
                trajectories[end:, inv_idx] = -72
                visibilities[end:, inv_idx] = float(
                    PointVisibilityType.REINIT_FAILED)
                logits[inv_idx, end:] = NEG_INF

        # Frames never reached keep NaN logits: empty masks. np.where and
        # not np.nan_to_num, which would also turn the -inf sentinels of
        # gated planes into finite values.
        logits = np.where(np.isnan(logits), NEG_INF, logits)
        trajectories = np.where(np.isnan(trajectories), -72.0, trajectories)
        return trajectories, visibilities, logits, scores_per_frame

    def _choose_reinit_timestep(self, area, pred_masks_i, current_ts, start):
        """The window frame each mask re-initialises from, per
        `reinit_variant`; indices count the window's frames after its
        first. area [m_i, frames - 1] float64 (NaN = not a candidate)."""
        n = area.shape[0]
        variant = self.reinit_variant
        if variant == "reinit-on-horizon-and-sync-masks":
            nxt = self.reinit_horizon - 1 - 1
            others = current_ts[current_ts > start]
            if len(others) > 0:
                nxt = min(nxt, int(others.min()) - start - 1)
            return np.full((n,), min(nxt, area.shape[1] - 1), np.int64)
        if variant == "reinit-at-median-of-area-diff":
            out = np.zeros((n,), np.int64)
            for i in range(n):
                vals = area[i]
                if np.isnan(vals).all():
                    continue
                # the lower median of the finite areas (torch.nanmedian),
                # not np.nanmedian's mean of the two middle values
                finite = np.sort(vals[~np.isnan(vals)])
                med = finite[(finite.size - 1) // 2]
                out[i] = int(np.where(np.isnan(vals), np.inf,
                                      np.abs(vals - med)).argmin())
            return out
        if variant == "reinit-on-similar-mask-area":
            target = pred_masks_i[:, 0].sum(axis=(1, 2)).astype(np.float64)
            diff = np.abs(area - target[:, None])
            return np.where(np.isnan(diff), np.inf, diff).argmin(axis=1)
        if variant == "reinit-on-similar-mask-area-and-sync-masks":
            target = pred_masks_i[:, 0].sum(axis=(1, 2)).astype(np.float64)
            diff = (np.abs(area - target[:, None])
                    / np.maximum(target[:, None], 1))
            per_frame = np.where(np.isnan(diff), 720.0, diff).sum(axis=0)
            others = current_ts[current_ts > start]
            if len(others) > 0:
                sync = int(others.min()) - start - 1
                if 0 <= sync < len(per_frame):
                    per_frame[sync] -= 36.0
            return np.full((n,), int(per_frame.argmin()), np.int64)
        raise ValueError(f"Unknown reinit variant: {variant}")
