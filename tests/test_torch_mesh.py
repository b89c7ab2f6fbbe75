"""The port's device mesh (``repro_torch.distributed.mesh``): every
collective on a 4-shard and a 2 x 2 mesh of CPU shards against numpy,
the same bits on every member and on every call, a shard that raises or
stalls failing the call within its timeout, the counters, and values
that stay per shard.

The meshes name the CPU four times, as the reference's tests run several
shards on forced host devices of one CPU.  Inputs are seeded with numpy;
integer results are exact, float sums are held to numpy's at 1e-6
relative (numpy sums in another order) and to themselves bit for bit.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import memory
from repro_torch.distributed import mesh as M
from repro_torch.distributed.mesh import P

FLOAT_TOL = 1e-6

MESHES = {
    "pool4": lambda: M.make_device_mesh(4, devices=["cpu"] * 4),
    "data2xmodel2": lambda: M.make_mesh((2, 2), ("data", "model"),
                                        ["cpu"] * 4),
}


def _blocks(mesh, x, spec):
    """Each shard's block of ``x`` by ``spec``, as numpy (by rank)."""
    return [M._local_block(mesh, torch.from_numpy(x), spec, r).numpy()
            for r in range(mesh.size)]


def _groups(mesh, axes):
    """rank -> the ranks of its group over ``axes`` (group order)."""
    out = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        grp = []
        for q in range(mesh.size):
            cq = mesh.coords(q)
            if all(cq[a] == c[a] for a in mesh.axis_names if a not in axes):
                grp.append(q)
        key = [tuple(mesh.coords(q)[a] for a in axes) for q in grp]
        out[r] = [q for _, q in sorted(zip(key, grp))]
    return out


def _run(mesh, fn, x, spec):
    """``fn`` per shard on ``x``'s blocks; every shard's result (by rank)."""
    out = M.shard_map(lambda xl: fn(xl)[None], mesh, in_specs=(spec,),
                      out_specs=P(tuple(mesh.axis_names)))(
        torch.from_numpy(x))
    return [s[0].numpy() for s in out.shards]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("op", ["psum", "pmax", "pmean"])
@pytest.mark.parametrize("dtype", [np.int64, np.float32])
def test_reductions_match_numpy(mesh_name, op, dtype):
    mesh = MESHES[mesh_name]()
    axes = mesh.axis_names[-1:]
    rng = np.random.default_rng(len(op))
    x = (rng.integers(-1000, 1000, (8, 6)) if dtype == np.int64
         else rng.standard_normal((8, 6))).astype(dtype)
    spec = P(tuple(mesh.axis_names))
    if op == "pmean" and dtype == np.int64:
        x = x.astype(np.float32)
    fn = {"psum": M.psum, "pmax": M.pmax, "pmean": M.pmean}[op]
    got = _run(mesh, lambda xl: fn(xl, axes), x, spec)
    blocks = _blocks(mesh, x, spec)
    groups = _groups(mesh, axes)
    for r in range(mesh.size):
        parts = np.stack([blocks[q] for q in groups[r]])
        want = {"psum": parts.sum(0), "pmax": parts.max(0),
                "pmean": parts.mean(0)}[op]
        if want.dtype.kind == "i":
            assert np.array_equal(got[r], want)
        else:
            np.testing.assert_allclose(got[r], want, rtol=FLOAT_TOL,
                                       atol=FLOAT_TOL)
        # every member of a group holds the same bits
        for q in groups[r]:
            assert got[q].tobytes() == got[r].tobytes()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("tiled,axis", [(False, 0), (True, 0), (True, 1),
                                        (False, 2)])
def test_all_gather_matches_numpy(mesh_name, tiled, axis):
    mesh = MESHES[mesh_name]()
    axes = tuple(mesh.axis_names)
    x = np.arange(4 * 3 * 5, dtype=np.int64).reshape(4 * 3, 5)
    spec = P(axes)
    blocks = _blocks(mesh, x, spec)
    out = M.shard_map(lambda xl: M.all_gather(xl, axes, axis=axis,
                                              tiled=tiled)[None],
                      mesh, in_specs=(spec,), out_specs=P(axes))(
        torch.from_numpy(x))
    want = np.concatenate(blocks, axis) if tiled \
        else np.stack(blocks, axis)
    for s in out.shards:
        assert np.array_equal(s[0].numpy(), want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("split_axis,concat_axis", [(0, 0), (1, 0), (0, 1)])
def test_all_to_all_matches_numpy(mesh_name, split_axis, concat_axis):
    mesh = MESHES[mesh_name]()
    axis = mesh.axis_names[0]
    g = mesh.shape[axis]
    rng = np.random.default_rng(split_axis * 3 + concat_axis)
    x = rng.integers(0, 1 << 20, (mesh.size * 4, 2 * g)).astype(np.int64)
    spec = P(tuple(mesh.axis_names))
    blocks = _blocks(mesh, x, spec)
    groups = _groups(mesh, (axis,))
    got = M.shard_map(lambda xl: M.all_to_all(xl, axis, split_axis,
                                              concat_axis, tiled=True),
                      mesh, in_specs=(spec,), out_specs=spec)(
        torch.from_numpy(x))
    for r in range(mesh.size):
        me = groups[r].index(r)
        parts = [np.split(blocks[q], g, axis=split_axis)[me]
                 for q in groups[r]]
        assert np.array_equal(got.shards[r].numpy(),
                              np.concatenate(parts, concat_axis))


def test_axis_index_and_size():
    mesh = MESHES["data2xmodel2"]()

    def f(x):
        return torch.tensor([[M.axis_index("data"), M.axis_index("model"),
                              M.axis_index(("data", "model")),
                              M.axis_size("model"),
                              M.axis_size(("data", "model"))]])

    out = M.shard_map(f, mesh, in_specs=(P(),),
                      out_specs=P(("data", "model")))(torch.zeros(1))
    assert out.full().tolist() == [[0, 0, 0, 2, 4], [0, 1, 1, 2, 4],
                                   [1, 0, 2, 2, 4], [1, 1, 3, 2, 4]]


def test_float_sums_are_the_same_bits_every_call():
    mesh = MESHES["pool4"]()
    x = (np.random.default_rng(1).standard_normal((4, 257)) * 1e3) \
        .astype(np.float32)
    fn = M.shard_map(lambda xl: M.psum(xl * 1.1, "pool"), mesh,
                     in_specs=(P("pool"),), out_specs=P("pool"))
    a = fn(torch.from_numpy(x))
    b = fn(torch.from_numpy(x))
    for sa, sb in zip(a.shards, b.shards):
        assert sa.numpy().tobytes() == sb.numpy().tobytes()
        assert sa.numpy().tobytes() == a.shards[0].numpy().tobytes()


def test_a_shard_that_raises_fails_the_call():
    mesh = MESHES["data2xmodel2"]()

    def f(x):
        if M.axis_index("data") == 1 and M.axis_index("model") == 0:
            raise ValueError("shard 2 broke")
        return M.psum(x, "data")

    t = time.monotonic()
    with pytest.raises(ValueError, match="shard 2 broke"):
        M.shard_map(f, mesh, in_specs=(P(),), out_specs=P(),
                    timeout=30)(torch.zeros(3))
    assert time.monotonic() - t < 5


def test_shards_that_diverge_fail_the_call():
    mesh = MESHES["pool4"]()

    def f(x):
        if M.axis_index("pool") == 3:
            return x
        return M.psum(x, "pool")

    t = time.monotonic()
    with pytest.raises(RuntimeError, match="diverged"):
        M.shard_map(f, mesh, in_specs=(P(),), out_specs=P(),
                    timeout=30)(torch.zeros(3))
    assert time.monotonic() - t < 5


def test_a_shard_that_stalls_times_out():
    mesh = MESHES["pool4"]()

    def f(x):
        if M.axis_index("pool") == 1:
            time.sleep(1.5)
        return M.psum(x, "pool")

    t = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        M.shard_map(f, mesh, in_specs=(P(),), out_specs=P(),
                    timeout=0.5)(torch.zeros(3))
    assert time.monotonic() - t < 10


def test_collectives_outside_shard_map_raise():
    with pytest.raises(RuntimeError, match="inside shard_map"):
        M.psum(torch.zeros(1), "pool")


def test_counters_count_calls_and_bytes():
    mesh = MESHES["data2xmodel2"]()
    x = torch.zeros(8, 16, dtype=torch.float32)     # blocks of 2 x 16

    def f(xl):
        M.psum(xl, "model")                         # groups of 2
        M.all_gather(xl, ("data", "model"))         # one group of 4
        M.all_to_all(xl, "data", 1, 1, tiled=True)  # halves of 2 x 8
        return xl

    mesh.reset_stats()
    M.shard_map(f, mesh, in_specs=(P(("data", "model")),),
                out_specs=P(("data", "model")))(x)
    blk = 2 * 16 * 4
    assert mesh.collective_counts() == {"all-reduce": 1, "all-gather": 1,
                                        "all-to-all": 1}
    assert mesh.collective_bytes() == {"all-reduce": 4 * 1 * blk,
                                       "all-gather": 4 * 3 * blk,
                                       "all-to-all": 4 * 1 * blk // 2}


def test_sharded_values_pass_through_without_copy():
    mesh = MESHES["pool4"]()
    pool = torch.arange(4 * 10, dtype=torch.int64).reshape(4, 10)
    sh = memory.shard_pool(pool, mesh)
    assert isinstance(sh, M.Sharded) and tuple(sh.shape) == (4, 10)
    # a row on its shard's device is a view, not a copy
    assert [s.data_ptr() for s in sh.shards] == \
        [pool[r].data_ptr() for r in range(4)]
    seen = M.shard_map(lambda x: torch.tensor([x.data_ptr()]), mesh,
                       in_specs=(P("pool", None),), out_specs=P("pool"))(sh)
    assert seen.full().tolist() == [pool[r].data_ptr() for r in range(4)]
    assert torch.equal(sh.full(), pool)
    assert memory.shard_pool(sh, mesh) is sh
    with pytest.raises(ValueError):
        M.shard_map(lambda x: x, mesh, in_specs=(P(None, "pool"),),
                    out_specs=P())(sh)


def test_stacked_sharded_values_index_per_shard():
    mesh = MESHES["data2xmodel2"]()
    w = torch.arange(3 * 4 * 6, dtype=torch.float32).reshape(3, 4, 6)
    sh = mesh.put(w, P(None, "model", "data"))
    assert tuple(sh.shape) == (3, 4, 6)
    layer = sh[1]
    assert layer.spec == P("model", "data")
    assert torch.equal(layer.full(), w[1])
    assert [tuple(s.shape) for s in layer.shards] == [(2, 3)] * 4


def test_make_device_mesh_never_shrinks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        M.make_device_mesh(4)
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        M.make_device_mesh(2, device_type="cpu")
    assert M.make_device_mesh(1, device_type="cpu").size == 1
    assert M.device_count("cuda") == 0 and M.device_count("cpu") == 1
    with pytest.raises(ValueError):
        M.make_device_mesh(4, devices=["cpu"] * 3)
    mesh = M.make_device_mesh(3, axis="x", devices=["cpu"] * 3)
    assert mesh.shape == {"x": 3} and mesh.flat_devices == \
        [torch.device("cpu")] * 3
