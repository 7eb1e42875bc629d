"""VOS evaluation harness (counterpart of `sam_pt_tpu/vos_eval/eval.py`;
XMem-style loop, reference sam_pt/vos_eval/eval.py).

Per video: load frames + GT index masks (MaskMapper remapping), call the
model per mask batch, fuse per-mask logits with a background channel +
argmax, overwrite GT at query frames, save palette PNGs, track FPS, and
auto-score DAVIS val (J&F) and BDD100K with the native scorers.

Run:  python -m sam_pt_torch.vos_eval.eval dataset=D17 d17_path=... [device=cpu]
Debug subsetting flags mirror the reference: max_videos, max_frames, vid_ids.

Device fusion: masks are suppressed before their query frame, overwritten
with the ground truth at it, and fused by argmax against a zero background
channel (argmax of the softmax == argmax of the logits). With <= 15 objects
the index mask is nibble-packed along W on the device, two pixels per byte.
The model's `forward` returns device tensors: the fusion takes its logits
as they are; the host branch (`save_scores`, `save_overlapping_masks`)
downloads them.
"""
from __future__ import annotations

import copy
import os
import sys
import time
from os import path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import compose, instantiate, resolve_interpolations
from ..parallel.mesh import join_launched_world
from ..utils import tracing
from ..utils.util import seed_all
from .data.image_io import write_png
from .data.mask_mapper import MaskMapper
from .data.test_datasets import (
    BDD100KTestDataset,
    DAVISTestDataset,
    LongTestDataset,
    MOSETestDataset,
    YouTubeVOSTestDataset,
)
from .data.video_reader import nearest_resize_index
from .davis2017eval import Davis2017Evaluator
from .evaluator import VOSEvaluator

CONFIG_DIR = path.join(path.dirname(__file__), "..", "configs")
# Harness-owned directories under the output, which are not sequences.
NON_SEQUENCE = {"overlapping", "logs", "Scores", "Annotations", "viz"}


def build_dataset(cfg):
    dataset = cfg["dataset"]
    split = cfg.get("split", "val")
    size = cfg.get("size", -1)
    longest_size = cfg.get("longest_size")

    if dataset == "D17":
        root = path.join(cfg["d17_path"], "trainval" if split == "val" else "test-dev")
        imset = "2017/val.txt" if split == "val" else "2017/test-dev.txt"
        return DAVISTestDataset(
            root, imset=imset, size=size, longest_size=longest_size,
            return_all_gt_masks=cfg.get(
                "simulate_interactive_point_correction", False),
        )
    if dataset == "D16":
        return DAVISTestDataset(
            cfg["d16_path"],
            imset="../../2017/trainval/ImageSets/2016/val.txt",
            size=size, longest_size=longest_size,
        )
    if dataset in ("Y18", "Y19"):
        root = cfg["y18_path"] if dataset == "Y18" else cfg["y19_path"]
        return YouTubeVOSTestDataset(
            root, split="valid" if split == "val" else split,
            size=size, longest_size=longest_size,
        )
    if dataset in ("LV1", "LV3"):
        sub = "long_video" if dataset == "LV1" else "long_video_x3"
        return LongTestDataset(path.join(cfg["lv_path"], sub),
                               longest_size=longest_size)
    if dataset == "G":
        return LongTestDataset(cfg["generic_path"], size=size,
                               longest_size=longest_size)
    if dataset == "MOSE":
        return MOSETestDataset(cfg["mose_path"], split=split,
                               shortest_size=size, longest_size=longest_size)
    if dataset == "BDD100K":
        return BDD100KTestDataset(cfg["bdd100k_path"], split=split,
                                  shortest_size=size, longest_size=longest_size)
    raise NotImplementedError(dataset)


def one_point_query_masks(model, images, query_masks, gt_ti_list):
    """SAM masks from one k-medoids point per object, each decoded on its
    query frame (reference :238-257). The point is drawn, as in the JAX
    harness, from a generator that is not seeded."""
    from ..utils.query_points import extract_kmedoid_points

    out = []
    predictor = model.sam_predictor
    h, w = images.shape[1:3]
    for mi, (mask, ti) in enumerate(zip(query_masks, gt_ti_list)):
        pt = extract_kmedoid_points(mask, 1)
        frame = torch.from_numpy(images[int(ti)][None]).to(model.device)
        emb = predictor.encode_frames(frame, (h, w))
        low, iou, _ = predictor.predict(emb, pt[None], np.ones((1, 1)),
                                        (h, w))
        logits = predictor.upscale_logits(low[:, 0], (h, w))
        m = (logits[0] > 0).float().cpu().numpy()
        print(f"[One GT Point Only] Mask {mi}, t={ti}, "
              f"IoU {float(iou[0, 0]) * 100:6.2f}")
        out.append(m)
    return np.stack(out)


def softmax_fuse(logits: np.ndarray) -> np.ndarray:
    """[T, 1+M, H, W] logits (channel 0 = zero background) -> probs."""
    x = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=1, keepdims=True)


_BIG = 60000.0  # float16-representable stand-in for +-inf


def fuse_chunk(chunk_logits: torch.Tensor, frame_ids: torch.Tensor,
               gt: torch.Tensor, ts: torch.Tensor,
               pack: bool) -> torch.Tensor:
    """chunk_logits [M, F, h, w] float16, frame_ids [F], gt [M, h, w] bool,
    ts [M] -> index masks [F, h, w] uint8 (or [F, h, ceil(w/2)] packed)."""
    big = torch.tensor(_BIG, dtype=torch.float16, device=chunk_logits.device)
    x = chunk_logits.to(torch.float16)
    before = frame_ids[None, :] < ts[:, None]  # [M, F]
    x = torch.where(before[..., None, None], -big, x)
    at_query = frame_ids[None, :] == ts[:, None]
    gt_val = torch.where(gt[:, None], big, -big)  # [M, 1, h, w]
    x = torch.where(at_query[..., None, None], gt_val, x)
    stacked = torch.cat([torch.zeros_like(x[:1]), x], dim=0)
    idx = torch.argmax(stacked, dim=0).to(torch.uint8)  # [F, h, w]
    if pack:
        if idx.shape[-1] % 2:
            idx = torch.nn.functional.pad(idx, (0, 1))
        return idx[..., 0::2] | (idx[..., 1::2] << 4)
    return idx


class PendingIndexMasks:
    """Fused index masks on the device whose download is deferred.

    `get()` starts every chunk's copy into pinned host memory without
    blocking, waits once, and assembles the [T, h, w] uint8 array, in a
    `fuse.download` span of the video the masks were made for."""

    def __init__(self, chunks: List[Tuple[torch.Tensor, int, int]], t: int,
                 h: int, w: int, packed: bool = False):
        self._chunks = chunks
        self._t, self._h, self._w = t, h, w
        self._packed = packed
        self._video = tracing.current_video()  # the video it was made for

    def get(self) -> np.ndarray:
        device = self._chunks[0][0].device if self._chunks else None
        with tracing.span("fuse.download", video=self._video, device=device,
                          bytes=sum(m.nbytes for m, _, _ in self._chunks)):
            hosts = []
            for masks, i, end in self._chunks:
                host = torch.empty(masks.shape, dtype=masks.dtype,
                                   pin_memory=masks.is_cuda)
                host.copy_(masks, non_blocking=True)
                hosts.append((host, i, end))
            if any(m.is_cuda for m, _, _ in self._chunks):
                torch.cuda.current_stream(device).synchronize()
            out = np.zeros((self._t, self._h, self._w), np.uint8)
            for host, i, end in hosts:
                got = host.numpy()[: end - i]
                if self._packed:
                    unpacked = np.empty(
                        (got.shape[0], got.shape[1], 2 * got.shape[2]),
                        np.uint8)
                    unpacked[..., 0::2] = got & 0x0F
                    unpacked[..., 1::2] = got >> 4
                    got = unpacked[..., : self._w]
                out[i:end] = got
            self._chunks = []
            return out


def device_fuse_index_masks(logits_dev: torch.Tensor, gt_masks: np.ndarray,
                            gt_ts, frame_chunk: int = 16,
                            defer: bool = False):
    """logits_dev [M, T, h, w] (device), gt_masks [M, h, w], gt_ts [M] ->
    [T, h, w] uint8 index masks (or a `PendingIndexMasks` with defer)."""
    m, t, h, w = logits_dev.shape
    device = logits_dev.device
    with tracing.span("fuse", device=device, frames=t):
        gt = torch.as_tensor(np.asarray(gt_masks) > 0.5, device=device)
        ts = torch.as_tensor(np.asarray(gt_ts, np.int64), device=device)
        pack = m <= 15
        chunks = []
        for i in range(0, t, frame_chunk):
            end = min(i + frame_chunk, t)
            ids = np.concatenate([np.arange(i, end),
                                  np.full(frame_chunk - (end - i), i)])
            ids = torch.as_tensor(ids, device=device)
            chunks.append((fuse_chunk(logits_dev[:, ids], ids, gt, ts, pack),
                           i, end))
        pending = PendingIndexMasks(chunks, t, h, w, packed=pack)
    return pending if defer else pending.get()


def _resize_frames_host(images: np.ndarray, hw) -> np.ndarray:
    """[T, H, W, 3] uint8 -> [T, *hw, 3] uint8 (Pillow bilinear, on the
    host)."""
    if images.shape[1:3] == tuple(hw):
        return images
    from PIL import Image

    return np.stack([
        np.asarray(Image.fromarray(f).resize((hw[1], hw[0]), Image.BILINEAR))
        for f in images
    ])


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def _visualize_video(cfg, vid_name, images, target_hw, logits_mt,
                     gt_resized_all, gt_ti_list, trajectories, visibilities):
    """Render the per-video prediction overlay (reference eval.py:389-418)
    to `output/viz/<video>.<log_fmt>`: the fused logits with pre-query
    suppression and GT overwrite, the trajectories and per-visibility
    point colours. Runs outside the timed region, so the downloads of the
    device tensors land here."""
    from ..utils.viz import render_predictions, save_video

    lg = _host(logits_mt).astype(np.float32)
    if trajectories is not None:
        trajectories = np.concatenate([_host(x) for x in trajectories],
                                      axis=1)
        visibilities = np.concatenate([_host(x) for x in visibilities],
                                      axis=1)
    for i, ti in enumerate(gt_ti_list):
        lg[i, :ti] = -1e8
        lg[i, ti] = np.where(gt_resized_all[i] > 0.5, 1e8, -1e8)
    resized = _resize_frames_host(images, target_hw)
    frames = render_predictions(
        resized,
        [lg[i] for i in range(lg.shape[0])],
        trajectories, visibilities,
    )
    fmt = cfg.get("log_fmt", "gif")
    out = path.join(cfg["output"], "viz", f"{vid_name}.{fmt}")
    save_video(frames, out)
    if cfg.get("verbose_visualisations", False):
        save_video(resized,
                   path.join(cfg["output"], "viz", f"{vid_name}_input.{fmt}"))
    print(f"Saved visualization to {out}")


class _PendingVideo(NamedTuple):
    """A processed video whose fused-mask download is still in flight."""

    pending: PendingIndexMasks
    t_frames: int
    infos: List[dict]
    mapper: MaskMapper
    palette: object
    vid_name: str
    flip: bool

    def resolve_masks(self) -> np.ndarray:
        masks = self.pending.get()
        return masks[..., ::-1] if self.flip else masks


def evaluate(cfg) -> Dict:
    """The evaluation `cfg` composes. With `trace_output` set, the port's
    tracer (`utils/tracing.py`) records the run, and its spans are written
    there as Chrome trace-event JSON once the last video's masks are in."""
    if not cfg.get("trace_output"):
        return _evaluate(cfg)
    tracing.enable()
    try:
        return _evaluate(cfg)
    finally:
        tracing.disable()


def _evaluate(cfg) -> Dict:
    seed_all(cfg.get("seed", 72))

    if cfg.get("output_timestamped", False):
        # opt-in analogue of the reference's Hydra job-chdir run dirs
        # (configs/vos_eval_root.yaml:48-55). Default OFF: stable output
        # paths are what resume-by-skip keys on.
        cfg = copy.copy(cfg)
        cfg["output"] = (
            f"{cfg['output']}_{cfg.get('dataset', '')}_"
            f"{cfg.get('split', '')}_{cfg.get('seed', 72)}_"
            f"{time.strftime('%Y.%m.%d_%H.%M.%S')}"
        )

    meta_dataset = build_dataset(cfg)
    out_path = cfg["output"]
    if cfg["dataset"].startswith("Y") or cfg.get("save_scores", False):
        out_path = path.join(out_path, "Annotations")

    model = instantiate(cfg["model"])
    device = getattr(model, "device", None)
    if device is not None:
        print(f"Model on {device}")
    evaluator: VOSEvaluator = instantiate(
        cfg.get("evaluator", {
            "_target_": "sam_pt_torch.vos_eval.evaluator.SamPtEvaluator"
        }),
        cfg=cfg, model=model,
    )

    max_videos = cfg.get("max_videos")
    max_frames = cfg.get("max_frames")
    vid_ids = cfg.get("vid_ids")
    masks_batch_size = cfg.get("masks_batch_size", 100)
    interactive = cfg.get("simulate_interactive_point_correction", False)
    if interactive:
        # SamPtInteractive simulates one object at a time, and the
        # per-batch gt_masks slice below is aligned only at batch size 1
        masks_batch_size = 1
    save_all = cfg.get("save_all", False)

    total_process_time = 0.0
    total_frames = 0
    prev_video: Optional[_PendingVideo] = None  # cross-video pipelining

    def _save_outputs(infos_v, t_frames_v, mapper_v, palette_v, vid_name_v,
                      index_masks: np.ndarray, probs=None) -> None:
        """Palette PNGs for save frames (+ probability .npz when scoring).

        Shared by the device-fusion (deferred download) and host-fusion
        paths. With `probs`, the label-remapping backward.json is written
        unconditionally — score consumers need it even when the final frame
        is not a save frame."""
        for ti in range(t_frames_v):
            info = infos_v[ti]
            if not (save_all or info["save"]):
                continue
            out_mask = mapper_v.remap_index_mask(index_masks[ti])
            this_out = path.join(out_path, vid_name_v)
            os.makedirs(this_out, exist_ok=True)
            write_png(path.join(this_out, info["frame"][:-4] + ".png"),
                      out_mask, palette_v)
            if probs is not None:
                np_path = path.join(cfg["output"], "Scores", vid_name_v)
                os.makedirs(np_path, exist_ok=True)
                np.savez_compressed(
                    path.join(np_path, info["frame"][:-4] + ".npz"),
                    probs=(probs[ti] * 255).astype(np.uint8),
                )
        if probs is not None:
            import json

            np_path = path.join(cfg["output"], "Scores", vid_name_v)
            os.makedirs(np_path, exist_ok=True)
            with open(path.join(np_path, "backward.json"), "w") as f:
                json.dump(
                    {int(k): int(v)
                     for k, v in mapper_v.remappings.items()}, f)

    def _save_pngs(pv: _PendingVideo, index_masks: np.ndarray) -> None:
        _save_outputs(pv.infos, pv.t_frames, pv.mapper, pv.palette,
                      pv.vid_name, index_masks)

    for vid_id, vid_reader in enumerate(meta_dataset.get_datasets()):
        if vid_ids is not None and vid_id not in vid_ids:
            continue
        if max_videos is not None and vid_id >= max_videos:
            break
        vid_name = vid_reader.vid_name
        if path.exists(out_path) and vid_name in os.listdir(out_path):
            print(f"Already processed {vid_name}, skipping (resume-by-skip)")
            continue
        print(f"Processing {vid_name}... [{vid_id + 1}/{len(meta_dataset)}]")

        mapper = MaskMapper()
        rgbs: List[np.ndarray] = []
        infos: List[dict] = []
        gt_ti_list: List[int] = []
        gt_mask_list: List[np.ndarray] = []
        gt_labels_list: List[int] = []
        all_gt_masks: List[np.ndarray] = []  # per-frame one-hot (interactive)

        for ti, data in enumerate(vid_reader):
            if max_frames is not None and ti >= max_frames:
                break
            rgb = data["rgb"]
            msk = data.get("mask")
            info = data["info"]

            if cfg.get("flip", False):  # horizontal-flip evaluation
                rgb = rgb[:, ::-1].copy()
                msk = msk[:, ::-1].copy() if msk is not None else None

            if cfg["dataset"] == "BDD100K" and msk is not None:
                seen = np.isin(msk, mapper.labels)
                msk = msk.copy()
                msk[seen] = 0
                if msk.sum() == 0:
                    msk = None

            if msk is not None:
                onehot, new_mapped = mapper.convert_mask(
                    msk, old_labels_allowed=interactive)
                if info["need_resize"]:
                    onehot = vid_reader.resize_mask(onehot)
                if interactive:
                    all_gt_masks.append(onehot)
                inv = {v: k for k, v in mapper.remappings.items()}
                for l_remapped in new_mapped:
                    l_original = inv[l_remapped]
                    if l_original not in gt_labels_list:
                        m = onehot[l_remapped - 1]
                        assert m.sum() > 0
                        gt_mask_list.append(m)
                        gt_ti_list.append(ti)
                        gt_labels_list.append(l_original)

            rgbs.append(rgb)
            infos.append(info)

        if not gt_mask_list:
            print(f"No GT masks for {vid_name}, skipping")
            continue

        height, width = infos[0]["shape"]
        target_hw = (int(height), int(width))
        images = np.stack(rgbs)
        query_masks = np.stack(gt_mask_list)
        query_ts = np.asarray(gt_ti_list, np.float32)
        n_masks = query_masks.shape[0]

        if cfg.get("input_only_one_gt_mask_point", False):
            # SAM masks from ONE k-medoids point per object in place of the
            # ground-truth query masks (reference vos_eval/eval.py:238-257)
            query_masks = one_point_query_masks(model, images, query_masks,
                                                gt_ti_list)

        viz_this = (
            cfg.get("visualize_results", False)
            and vid_id < cfg.get("max_videos_to_visualize", 30)
            and (cfg.get("vid_ids_to_visualize") is None
                 or vid_id in cfg["vid_ids_to_visualize"])
        )
        save_overlapping = cfg.get("save_overlapping_masks", False)

        start = time.perf_counter()

        # device fusion keeps per-mask logits on the device and only
        # downloads uint8 index masks; probability saving and the fused-
        # logits dump (save_overlapping_masks) need the host path
        device_fusion = (
            cfg.get("device_fusion", True)
            and not cfg.get("save_scores", False)
            and not save_overlapping
        )

        pred_logits = []
        device_parts = []
        viz_traj, viz_vis = [], []
        for i in range(0, n_masks, masks_batch_size):
            video = {
                "video_name": vid_name,
                "video_id": f"{vid_id:03d}--{vid_name}--mask-{i}",
                "image": images,
                "info": infos,
                "target_hw": target_hw,
                "query_masks": query_masks[i : i + masks_batch_size],
                "query_point_timestep": query_ts[i : i + masks_batch_size],
                "keep_logits_on_device": device_fusion,
            }
            if interactive and all_gt_masks:
                video["gt_masks"] = [m[i : i + 1] for m in all_gt_masks]
            outputs = evaluator.evaluate_video(video)
            if device_fusion:
                device_parts.append(outputs["logits"])  # [m_i, T, h, w]
            else:
                pred_logits.extend(outputs["logits"].float().cpu().numpy())
            if viz_this and outputs.get("trajectories") is not None:
                # device tensors: _visualize_video downloads them outside
                # the timed region
                viz_traj.append(outputs["trajectories"])
                viz_vis.append(outputs["visibilities"])

        t_frames = len(rgbs)
        gt_resized_all = np.stack(
            [nearest_resize_index(m, target_hw) for m in gt_mask_list]
        )

        if device_parts:
            logits_dev = (
                device_parts[0]
                if len(device_parts) == 1
                else torch.cat(device_parts, dim=0)
            )
            # dispatch fusion now; defer the uint8 download so it overlaps
            # the NEXT video's compute. The previous video's download is
            # resolved here, INSIDE this video's timed region, so
            # total_process_time still covers every download.
            pending = device_fuse_index_masks(
                logits_dev, gt_resized_all, gt_ti_list, defer=True
            )
            resolved_prev = None
            if prev_video is not None:
                resolved_prev = (prev_video, prev_video.resolve_masks())
            prev_video = _PendingVideo(
                pending=pending, t_frames=t_frames, infos=infos,
                mapper=mapper, palette=vid_reader.get_palette(),
                vid_name=vid_name, flip=bool(cfg.get("flip", False)),
            )
            total_process_time += time.perf_counter() - start
            total_frames += t_frames
            if resolved_prev is not None:  # PNG writes stay untimed
                _save_pngs(*resolved_prev)
            if viz_this:  # untimed, like the reference's post-timing viz
                _visualize_video(
                    cfg, vid_name, images, target_hw, logits_dev,
                    gt_resized_all, gt_ti_list,
                    viz_traj or None, viz_vis or None,
                )
            continue

        logits = np.stack(
            [np.zeros_like(pred_logits[0])] + pred_logits, axis=1
        )  # [T, 1+M, h, w]
        # zero out predictions before each mask's query frame; overwrite
        # GT at query frames (reference :319-325)
        for i, gt_ti in enumerate(gt_ti_list):
            logits[:gt_ti, i + 1] = -1e8
        for i, gt_ti in enumerate(gt_ti_list):
            logits[gt_ti, i + 1] = np.where(
                gt_resized_all[i] > 0.5, 1e8, -1e8
            )
        probs = softmax_fuse(logits)
        if cfg.get("flip", False):
            probs = probs[..., ::-1]  # saved probabilities are unflipped
        index_masks = probs.argmax(axis=1).astype(np.uint8)

        total_process_time += time.perf_counter() - start
        total_frames += t_frames

        # save palette PNGs (+ optional per-frame probability arrays)
        _save_outputs(
            infos, t_frames, mapper, vid_reader.get_palette(), vid_name,
            index_masks,
            probs=probs if cfg.get("save_scores", False) else None,
        )
        if save_overlapping:
            # fused multi-object logits, suppression + GT overwrite applied
            # (reference eval.py:383-386 torch.save of `logits` under a
            # sibling `overlapping/` dir; .npz here)
            np_path = path.join(cfg["output"], "..", "overlapping", vid_name)
            os.makedirs(np_path, exist_ok=True)
            np.savez_compressed(
                path.join(np_path, "logits.npz"), logits=logits
            )
        if viz_this:
            _visualize_video(
                cfg, vid_name, images, target_hw,
                logits.transpose(1, 0, 2, 3)[1:],
                gt_resized_all, gt_ti_list,
                viz_traj or None, viz_vis or None,
            )

    if prev_video is not None:  # resolve the last video's deferred download
        t0 = time.perf_counter()
        final_masks = prev_video.resolve_masks()
        total_process_time += time.perf_counter() - t0
        _save_pngs(prev_video, final_masks)
        prev_video = None
    if cfg.get("trace_output"):
        tracing.write(cfg["trace_output"])
        print(f"Trace: {cfg['trace_output']}")

    fps = total_frames / total_process_time if total_process_time > 0 else 0.0
    print(f"Total processing time: {total_process_time:.2f}s")
    print(f"Total processed frames: {total_frames}")
    print(f"FPS: {fps:.3f}")

    results = {"fps": fps, "total_frames": total_frames,
               "total_process_time": total_process_time}

    if not cfg.get("save_scores", False) and cfg.get("make_zip", True):
        # archive the results for submission (reference eval.py:430-435:
        # YouTube layouts zip the Annotations subtree, others the whole dir)
        import shutil

        print("Making zip...")
        if cfg["dataset"].startswith("Y"):
            shutil.make_archive(
                path.join(cfg["output"], path.basename(cfg["output"])),
                "zip", cfg["output"], "Annotations",
            )
        else:
            shutil.make_archive(cfg["output"], "zip", cfg["output"])

    from ..utils.logging import RunLogger

    logger = RunLogger(
        output_dir=path.join(cfg["output"], "logs"),
        exp_id=str(cfg.get("exp_id", "vos-eval")),
        config={k: v for k, v in cfg.items() if not isinstance(v, dict)},
        logging_cfg=cfg.get("logging"),
    )
    logger.set_summary(fps=fps, total_frames=total_frames,
                       total_process_time=total_process_time)

    if cfg["dataset"] in ("D16", "D17") and cfg.get("split", "val") == "val" \
            and cfg.get("score", True):
        sequences = "all"
        if vid_ids is not None or max_videos is not None:
            # list sequences where the PNGs actually went (out_path);
            # harness-owned dirs are NOT sequences
            sequences = sorted(
                s for s in os.listdir(out_path)
                if "." not in s and s not in NON_SEQUENCE
                and path.isdir(path.join(out_path, s))
            )
        if sequences != "all" and not sequences:
            print("No evaluated sequences found in the output dir — "
                  "skipping DAVIS scoring")
            logger.finish()
            return results
        df_global, df_per_seq = Davis2017Evaluator(
            results_path=out_path,
            davis_path=path.join(cfg["d17_path"], "trainval"),
            set="val",
            year="2017" if cfg["dataset"] == "D17" else "2016",
            sequences=sequences,
        ).evaluate()
        results["J&F-Mean"] = float(df_global["J&F-Mean"][0])
        results["df_global"] = df_global
        results["df_per_seq"] = df_per_seq
        logger.set_summary(score=results["J&F-Mean"])

    if cfg["dataset"] == "BDD100K" and cfg.get("split", "val") == "val" \
            and cfg.get("score", True):
        # auto-score like the reference (eval.py:463-478)
        from .bdd100keval import BDD100KEvaluator

        sequences = sorted(
            s for s in os.listdir(cfg["output"])
            if "." not in s and s not in NON_SEQUENCE
            and path.isdir(path.join(cfg["output"], s))
        )
        print(f"Sequences to evaluate: {sequences}")
        df_global, df_per_seq = BDD100KEvaluator(
            results_path=cfg["output"],
            dataset_path=path.join(cfg["bdd100k_path"],
                                   cfg.get("split", "val")),
            sequences=sequences,
        ).evaluate()
        results["df_global"] = df_global
        results["df_per_seq"] = df_per_seq
        logger.set_summary(n_sequences=len(sequences))

    logger.finish()
    return results


def main():
    """The CLI. Under `torchrun` it joins the group first over NCCL, one
    rank a card (`+dist_backend=gloo` for ranks that share a card or run
    on the CPU): `model.data_parallel=true` splits
    SAM's batches and `model.point_tracker.time_parallel=true` a video's
    frames over the ranks, which all evaluate every video; rank r > 0
    writes under `<output>_rank<r>` and its trace, with `trace_output`
    set, to `<stem>_rank<r><suffix>`, so no two ranks write one file."""
    overrides = [a for a in sys.argv[1:] if "=" in a]
    cfg = compose(CONFIG_DIR, "vos_eval_root", overrides)
    cfg = resolve_interpolations(cfg)
    if join_launched_world(cfg.get("dist_backend", "nccl"),
                           cfg.get("device", "cuda")):
        rank = torch.distributed.get_rank()
        if rank:
            cfg = copy.copy(cfg)
            cfg["output"] = f"{cfg['output']}_rank{rank}"
            if cfg.get("trace_output"):
                stem, suffix = path.splitext(cfg["trace_output"])
                cfg["trace_output"] = f"{stem}_rank{rank}{suffix}"
    return evaluate(cfg)


if __name__ == "__main__":
    main()
