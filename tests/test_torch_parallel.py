"""The port's collectives, meshes and evaluation sharding
(`sam_pt_torch/parallel/{comm,mesh,eval_sharding,launch}.py`) in gloo
worlds of 2 and 4 CPU ranks, against the JAX package's collectives on the
8-device virtual CPU mesh (conftest) and its sharding semantics.

- `psum` equals `lax.psum` under `shard_map` and keeps its input's
  dtype, as `lax.psum` does: float32 exactly; bf16 in bf16, bit-equal
  over 2 ranks (one rounding of the float32 sum on both sides) and, over
  4, within 4 roundings (each of gloo's 3 ring partial sums and the
  JAX CPU backend's one rounding of its float32 sum, each at most 2^-9
  of sum |x_r|).
- `ring_halo` equals the two `lax.ppermute`s of the JAX TapNet's
  temporal shift, with the global edges zeroed.
- `all_gather_cat` is exact: -0.0, -inf, NaN and bf16 bits come back as
  they were, with unequal parts, along any axis, on the int32 and the
  uint8 paths; it equals the concatenation in rank order that a
  `P(axis)` output sharding gives.
- `create_mesh` lays ranks out as the JAX `create_tp_mesh` lays devices
  (the model axis the faster-varying), with one group per row and
  column; `batch_sharding` splits and gathers as `P("data")` does.
- `shard_videos_across_hosts` gives each rank the JAX function's strided
  slice, and `gather_host_results` every rank's records (of unequal
  sizes) in rank order, as `tests/test_multiprocess_gather.py` checks
  for the JAX one.
- In one process every function is the identity of a world of one;
  `init_world` refuses NCCL with more ranks than cards, and
  `create_tp_mesh` a mesh larger than the world.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from sam_pt_torch.parallel import comm, eval_sharding
from sam_pt_torch.parallel.mesh import Mesh, create_mesh, init_world, \
    shard_batch
from sam_pt_torch.parallel.tensor_parallel import create_tp_mesh
from sam_pt_tpu.parallel import eval_sharding as jeval_sharding
from torch_parallel_worlds import comm_rank, cpu_world

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

MESH_SHAPES = {2: (1, 2), 4: (2, 2)}
ITEMS = list(range(10))
# bf16 bit patterns: -0.0, -inf, a NaN with a payload, 1.5, +inf, -2.
SPECIAL = np.array([-32768, -128, 32705, 16320, 32640, -16384], np.int16)


def _inputs(world):
    rng = np.random.default_rng(world)
    return [{"f32": rng.standard_normal(5).astype(np.float32),
             "first": rng.standard_normal((2, 3)).astype(np.float32),
             "last": rng.standard_normal((2, 3)).astype(np.float32),
             "special": SPECIAL[: r + 1].copy(),
             "rows": rng.standard_normal((2, r + 1)).astype(np.float32),
             "odd": rng.integers(0, 255, 2 * r + 1).astype(np.uint8)}
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds():
    """world size -> (inputs, each rank's results)."""
    out = {}
    for world in (2, 4):
        inputs = _inputs(world)
        out[world] = (inputs, cpu_world(
            world, comm_rank, inputs, MESH_SHAPES[world], ITEMS,
            [100 + 300 * r for r in range(world)]))
    return out


def _jax_ring(per_rank, world):
    """(from_left, from_right) of each rank by the JAX TapNet's ppermutes
    under shard_map."""
    mesh = JMesh(np.array(jax.devices()[:world]), ("t",))

    def body(first, last):
        n = jax.lax.axis_size("t")
        idx = jax.lax.axis_index("t")
        from_right = jax.lax.ppermute(first, "t",
                                      [(i, (i - 1) % n) for i in range(n)])
        from_left = jax.lax.ppermute(last, "t",
                                     [(i, (i + 1) % n) for i in range(n)])
        return (from_left * (idx > 0).astype(last.dtype),
                from_right * (idx < n - 1).astype(first.dtype))

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("t"), P("t")),
                           out_specs=(P("t"), P("t")), check_vma=False))
    first = jnp.stack([jnp.asarray(r["first"]) for r in per_rank])
    last = jnp.stack([jnp.asarray(r["last"]) for r in per_rank])
    left, right = fn(first, last)
    return np.asarray(left), np.asarray(right)


def _jax_psum(values, world):
    mesh = JMesh(np.array(jax.devices()[:world]), ("i",))
    fn = jax.jit(shard_map(lambda x: jax.lax.psum(x, "i"), mesh=mesh,
                           in_specs=P("i"), out_specs=P(), check_vma=False))
    return np.asarray(fn(jnp.concatenate([jnp.asarray(v)[None]
                                          for v in values])))[0]


@pytest.mark.parametrize("world", [2, 4])
def test_psum_matches_lax_psum(worlds, world):
    inputs, results = worlds[world]
    ref = _jax_psum([r["f32"] for r in inputs], world)
    bf16 = [jnp.asarray(r["f32"], jnp.bfloat16) for r in inputs]
    ref_bf16 = np.asarray(_jax_psum(bf16, world).astype(jnp.float32))
    bound = world * 2.0 ** -9 * sum(
        np.abs(np.asarray(b.astype(jnp.float32))) for b in bf16)
    for res in results:
        np.testing.assert_allclose(res["psum_f32"], ref, rtol=0, atol=1e-6)
        assert res["psum_f32"].dtype == np.float32
        assert res["psum_bf16_dtype"] == "torch.bfloat16"
        if world == 2:
            np.testing.assert_array_equal(res["psum_bf16"], ref_bf16)
        else:
            assert (np.abs(res["psum_bf16"] - ref_bf16) <= bound).all()


@pytest.mark.parametrize("world", [2, 4])
def test_ring_halo_matches_the_ppermutes(worlds, world):
    inputs, results = worlds[world]
    left, right = _jax_ring(inputs, world)
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["halo_left"], left[r])
        np.testing.assert_array_equal(res["halo_right"], right[r])
    assert not results[0]["halo_left"].any()
    assert not results[-1]["halo_right"].any()


@pytest.mark.parametrize("world", [2, 4])
def test_all_gather_cat_is_exact(worlds, world):
    inputs, results = worlds[world]
    bits = np.concatenate([r["special"] for r in inputs])
    rows = np.concatenate([r["rows"] for r in inputs], axis=1)
    odd = np.concatenate([r["odd"] for r in inputs])
    for res in results:
        np.testing.assert_array_equal(res["gather_special_bits"], bits)
        np.testing.assert_array_equal(res["gather_dim1"], rows)
        np.testing.assert_array_equal(res["gather_odd_u8"], odd)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_and_batch_sharding_lay_ranks_out_as_jax(worlds, world):
    inputs, results = worlds[world]
    n_data, n_model = MESH_SHAPES[world]
    grid = np.arange(world).reshape(n_data, n_model)  # create_tp_mesh
    batch = np.arange(4 * n_data * 3.0, dtype=np.float32).reshape(-1, 3)
    per = batch.shape[0] // n_data
    for r, res in enumerate(results):
        d, m = res["coords"]
        assert grid[d, m] == r
        model_ranks, data_ranks = grid[d], grid[:, m]
        np.testing.assert_allclose(
            res["psum_model"], sum(inputs[i]["f32"] for i in model_ranks),
            rtol=1e-6)
        np.testing.assert_allclose(
            res["psum_data"], sum(inputs[i]["f32"] for i in data_ranks),
            rtol=1e-6)
        np.testing.assert_array_equal(res["shard"],
                                      batch[d * per:(d + 1) * per])
        np.testing.assert_array_equal(res["gathered"], batch * 2)


@pytest.mark.parametrize("world", [2, 4])
def test_eval_sharding_matches_the_jax_semantics(worlds, world,
                                                 monkeypatch):
    _, results = worlds[world]
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for r, res in enumerate(results):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        assert res["videos"] == jeval_sharding.shard_videos_across_hosts(
            ITEMS)
        merged = res["records"]
        assert [m["video"] for m in merged] == [
            v for rank in range(world) for v in ITEMS[rank::world]]
        assert [len(m["blob"]) for m in merged] == [
            100 + 300 * m["rank"] for m in merged]
        assert sorted(m["video"] for m in merged) == ITEMS


def test_world_of_one_is_the_identity():
    x = torch.randn(3, 4)
    np.testing.assert_array_equal(comm.psum(x).numpy(), x.numpy())
    left, right = comm.ring_halo(x[:1], x[-1:])
    assert not left.any() and not right.any()
    assert comm.all_gather_cat(x, 1) is x
    mesh = create_mesh(("data", "model"))
    assert mesh.size == 1 and mesh.shape == {"data": 1, "model": 1}
    np.testing.assert_array_equal(shard_batch(x, mesh).numpy(), x.numpy())
    assert eval_sharding.shard_videos_across_hosts(ITEMS) == ITEMS
    assert eval_sharding.gather_host_results(["a"]) == ["a"]


def test_shard_batch_takes_the_rank_slice_and_refuses_uneven_batches():
    mesh = Mesh(("data",), {"data": 2}, {"data": 1}, {"data": None})
    x = torch.arange(8.0).reshape(4, 2)
    np.testing.assert_array_equal(shard_batch(x, mesh).numpy(),
                                  x[2:].numpy())
    got = shard_batch({"emb": x, "interm": x + 1}, mesh)
    np.testing.assert_array_equal(got["interm"].numpy(), x[2:].numpy() + 1)
    with pytest.raises(ValueError, match="pad it"):
        shard_batch(x[:3], mesh)


def test_init_world_refuses_nccl_with_more_ranks_than_cards(tmp_path):
    with pytest.raises(ValueError, match="nccl takes one rank per CUDA"):
        init_world("nccl", init_method=f"file://{tmp_path}/rdv", rank=0,
                   world_size=2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_create_tp_mesh_refuses_a_mesh_larger_than_the_world():
    with pytest.raises(ValueError, match="devices"):
        create_tp_mesh(n_model=2)
    with pytest.raises(ValueError, match="devices"):
        create_tp_mesh(n_model=1, n_data=2)
