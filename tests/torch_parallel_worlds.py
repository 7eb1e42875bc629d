"""Rank functions of the parallel-layer tests: each runs on every rank of a
gloo world spawned on the CPU by `sam_pt_torch.parallel.launch.run_world`
and returns numpy results to the test process, which holds them to the
JAX package and to the port's unsharded run. Torch-only: a rank imports
neither jax nor the JAX package."""
from __future__ import annotations

import numpy as np
import torch


def cpu_world(world: int, fn, *args, timeout: float = 240.0):
    """`fn(device, *args)` on `world` gloo ranks on the CPU."""
    from sam_pt_torch.parallel.launch import run_world

    return run_world(fn, world, backend="gloo", device="cpu", args=args,
                     timeout=timeout)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


# ---------------------------------------------------------------------------
# parallel/comm.py, mesh.py, eval_sharding.py
# ---------------------------------------------------------------------------

def comm_rank(device, inputs, mesh_shape, items, blob_sizes):
    """The collectives on this rank's slot of `inputs` (rank -> dict of
    arrays), the mesh of `mesh_shape` (data x model) and its groups, and
    the eval sharding of `items` with records of unequal sizes."""
    torch.set_num_threads(1)
    from sam_pt_torch.parallel import comm, eval_sharding
    from sam_pt_torch.parallel.mesh import batch_sharding, create_mesh

    rank = comm.group_rank()
    mine = {k: torch.from_numpy(v) for k, v in inputs[rank].items()}
    out = {"rank": rank}
    out["psum_f32"] = comm.psum(mine["f32"])
    psum_bf16 = comm.psum(mine["f32"].to(torch.bfloat16))
    out["psum_bf16"] = psum_bf16.float()
    out["psum_bf16_dtype"] = str(psum_bf16.dtype)
    left, right = comm.ring_halo(mine["first"], mine["last"])
    out["halo_left"], out["halo_right"] = left, right
    special = mine["special"].view(torch.bfloat16)
    out["gather_special_bits"] = comm.all_gather_cat(special).view(
        torch.int16)
    out["gather_dim1"] = comm.all_gather_cat(mine["rows"], dim=1)
    out["gather_odd_u8"] = comm.all_gather_cat(mine["odd"])
    mesh = create_mesh(("data", "model"), mesh_shape)
    out["coords"] = (mesh.axis_index("data"), mesh.axis_index("model"))
    out["psum_model"] = comm.psum(mine["f32"], mesh.group("model"))
    out["psum_data"] = comm.psum(mine["f32"], mesh.group("data"))
    batch = torch.arange(4 * mesh_shape[0] * 3.0).reshape(-1, 3)
    sharding = batch_sharding(mesh, "data")
    out["shard"] = sharding.shard(batch)
    out["gathered"] = sharding.gather(sharding.shard(batch) * 2)
    videos = eval_sharding.shard_videos_across_hosts(items)
    records = [{"video": v, "rank": rank, "blob": "x" * blob_sizes[rank]}
               for v in videos]
    out["videos"] = videos
    out["records"] = eval_sharding.gather_host_results(records)
    return _np(out)


# ---------------------------------------------------------------------------
# parallel/tensor_parallel.py
# ---------------------------------------------------------------------------

def tp_rank(device, encoders, predictor):
    """Each (encoder, x, n_model, n_data) of `encoders`: a copy of the
    port `ImageEncoderViT` sharded over a (n_data x n_model) mesh, x's
    frames split over the data axis and the embeddings gathered. Then,
    with `predictor` (sam, images, points, labels, n_model, n_data), a TP
    `SamPredictor` on that mesh: embeddings and `predict`'s outputs."""
    torch.set_num_threads(1)
    import copy

    from sam_pt_torch.models.sam.predictor import SamPredictor
    from sam_pt_torch.parallel.mesh import batch_sharding
    from sam_pt_torch.parallel.tensor_parallel import (
        create_tp_mesh,
        shard_params_tp,
    )

    out = {"encoders": []}
    with torch.no_grad():
        for encoder, x, n_model, n_data in encoders:
            mesh = create_tp_mesh(n_model=n_model, n_data=n_data)
            enc = shard_params_tp(copy.deepcopy(encoder), mesh)
            data = batch_sharding(mesh, "data")
            emb = data.gather(enc(data.shard(torch.from_numpy(x))))
            out["encoders"].append(
                {"emb": emb.float(),
                 "local_heads": enc.blocks[0].attn.num_heads,
                 "local_hidden": enc.blocks[0].mlp.lin1.out_features})
    if predictor is not None:
        sam, images, points, labels, n_model, n_data = predictor
        sam.tp_axis, sam.dp_axis = "model", "data"
        pred = SamPredictor(sam, mesh=create_tp_mesh(n_model, n_data))
        hw = tuple(images.shape[1:3])
        emb = pred.encode_frames(torch.from_numpy(images), hw)
        masks, iou, _ = pred.predict(emb, points, labels, hw)
        out["predictor"] = {"emb": emb, "masks": masks, "iou": iou}
    return _np(out)


def tp_block_rank(device, encoder, rows, hw, n_model):
    """The first block of a copy of the port `ImageEncoderViT` `encoder`,
    sharded over a model axis of `n_model` (every rank of the world), on
    token rows `rows` [B, N, C] (numpy float32, cast to the encoder's
    dtype) of an `hw` grid; float32 out."""
    torch.set_num_threads(1)
    import copy

    from sam_pt_torch.parallel.tensor_parallel import (
        create_tp_mesh,
        shard_params_tp,
    )

    enc = shard_params_tp(copy.deepcopy(encoder), create_tp_mesh(n_model))
    dtype = enc.pos_embed.dtype
    with torch.no_grad():
        out = enc.blocks[0](torch.from_numpy(rows).to(dtype), tuple(hw))
    return _np(out.float())


# ---------------------------------------------------------------------------
# parallel/temporal.py
# ---------------------------------------------------------------------------

def temporal_rank(device, models, video, query_points, trackers, rgbs,
                  tracker_queries):
    """Each (name, model) of `models` through its `*_forward_time_sharded`
    over the world's `data` axis, then each tracker of `trackers` with
    `time_parallel` over `rgbs`."""
    torch.set_num_threads(1)
    from sam_pt_torch.parallel.mesh import create_mesh
    from sam_pt_torch.parallel.temporal import (
        tapir_forward_time_sharded,
        tapnet_forward_time_sharded,
    )

    forward = {"tapnet": tapnet_forward_time_sharded,
               "tapir": tapir_forward_time_sharded}
    mesh = create_mesh()
    out = {}
    with torch.no_grad():
        for name, model in models.items():
            out[name] = forward[name](model, torch.from_numpy(video),
                                      torch.from_numpy(query_points), mesh)
    for name, tracker in trackers.items():
        tracker.time_parallel, tracker.mesh = True, mesh
        out[f"{name}_tracker"] = tracker.forward(
            torch.from_numpy(rgbs), tracker_queries)
    return _np(out)


# ---------------------------------------------------------------------------
# SamPt(data_parallel=True)
# ---------------------------------------------------------------------------

def sam_pt_rank(device, sam_pt, video):
    """`sam_pt` (data_parallel set) over `video` on this rank, with the
    chunks it rounded to."""
    torch.set_num_threads(1)
    out = sam_pt.forward(video)
    return _np({"out": out, "encode_chunk": sam_pt.sam_encode_chunk,
                "decode_chunk": sam_pt.sam_decode_chunk,
                "mesh_size": sam_pt.mesh.size})


# ---------------------------------------------------------------------------
# vis_eval.eval.evaluate over several processes
# ---------------------------------------------------------------------------

def vis_evaluate_rank(device, adapter, dataset, cfg):
    """`evaluate(cfg)` on this rank, the dataset (name, json, image root,
    class_agnostic) registered in this process first."""
    torch.set_num_threads(1)
    from sam_pt_torch.vis_eval.datasets import register_dataset
    from sam_pt_torch.vis_eval.eval import evaluate

    register_dataset(*dataset)
    return evaluate(dict(cfg, model=adapter))
