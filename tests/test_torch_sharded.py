"""hevctpu_torch.parallel: the multi-device encoder over torch.distributed,
held bit for bit to the port's own single-process encode (which
tests/test_torch_encoder.py holds to the JAX package).

Worlds of gloo ranks on the CPU, spawned per module: 4 ranks on a
(frame=2, tile=2) mesh with the 128x128 x 4 fixed-depth fixture of
tests/test_sharded.py, and 2 ranks on a (1, 2) mesh with its 64x128 x 4
CNN fixture. Every rank must return the whole batch's dict equal to the
single-process one, and its mesh's byte tally equal to the closed form
of the geometry. Each world has its own deadline: a stuck or failed
rank fails the test, and its processes are killed.

The wavefront tables are compared with the JAX package's Geometry
(numpy, no JAX compile); the JAX ShardedEncoder is not called.
"""

import datetime
import traceback

import numpy as np
import pytest
import torch

from hevctpu_torch.pipeline import encoder as E


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

WORLD_TIMEOUT_S = 200      # per world, below the 240 s a test may hang


def _clip(b, h, w, seed=7):
    """tests/test_sharded.py's synthetic clip."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([
        (128 + 70 * np.sin(yy / (7 + i)) * np.cos(xx / (11 + 2 * i))
         + rng.normal(0, 6, (h, w))).clip(0, 255).astype(np.int32)
        for i in range(b)])
    u = np.stack([(128 + 40 * np.cos(yy[::2, ::2] / (9 + i))).astype(np.int32)
                  for i in range(b)])
    v = rng.integers(60, 200, (b, h // 2, w // 2)).astype(np.int32)
    return y, u, v


COMPARED = ["recon_y", "recon_u", "recon_v", "levels_y", "levels_u",
            "levels_v", "cbf_y", "cbf_u", "cbf_v", "cbf4_y", "depth8",
            "coded8", "mode8", "mode4", "nxn8", "csel8", "sao_type",
            "sao_eo", "sao_bp", "sao_off", "tusz8"]

# the two worlds: (world size, h, w, frames, qp, clip seed, cnn?)
FIXED = dict(world=4, h=128, w=128, b=4, qp=32, seed=7, cnn=False)
CNN = dict(world=2, h=64, w=128, b=4, qp=37, seed=3, cnn=True)


def _refused(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _rank_main(rank, job, init, results):
    """One rank of a spawned world: the mesh (job["tile"] tiles, or
    make_mesh's default), the sharded encodes (halo exchange on, and off
    for the CNN world), the mesh's tally of the first, and the refusals
    that need a tile axis; puts (rank, dict) or (rank, traceback) on
    results."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        from hevctpu_torch.models import convnet2
        from hevctpu_torch.parallel import ShardedEncoder, make_mesh
        backend, dev = job.get("backend", "gloo"), job.get("device", "cpu")
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=job["world"],
                                timeout=datetime.timedelta(seconds=120))
        mesh = make_mesh(tile=job.get("tile"))
        h, w, qp = job["h"], job["w"], job["qp"]
        y, u, v = _clip(job["b"], h, w, job["seed"])
        src = (dict(cnn_params=convnet2.init_params(0)) if job["cnn"]
               else dict(fixed_depth=1))
        res = dict(shape=mesh.shape, coords=(mesh.frame_index,
                                             mesh.tile_index))
        sh = ShardedEncoder(h, w, qp, mesh, device=dev, **src)
        res["out"] = sh.encode(y, u, v)
        res["tally"] = mesh.tally
        if job["cnn"]:
            res["no_halo"] = ShardedEncoder(h, w, qp, mesh, device="cpu",
                                            halo_exchange=False,
                                            **src).encode(y, u, v)
            res["cc_refused"] = _refused(lambda: ShardedEncoder(
                h, 3 * 64, qp, mesh, device="cpu", **src))
            g = sh.enc.geom
            res["qp_map_refused"] = _refused(lambda: sh.enc.encode(
                y, u, v, np.ones((job["b"], g.rc * g.cc, 16), np.int8),
                qp_map=np.full((job["b"], g.rc, g.cc), qp)))
        elif mesh.frame > 1:
            res["batch_refused"] = _refused(lambda: sh.encode(
                y[:3], u[:3], v[:3]))
        dist.destroy_process_group()
        results.put((rank, res))
    except Exception:                     # reported to the parent
        results.put((rank, traceback.format_exc()))


def run_world(job):
    """Spawn job["world"] ranks of _rank_main and return their results by
    rank; fails (after killing every rank) when one fails or the world
    outlives WORLD_TIMEOUT_S."""
    from hevctpu_torch.parallel.scaling import run_world as spawn
    try:
        return spawn(dict(job, deadline_s=WORLD_TIMEOUT_S), _rank_main)[0]
    except RuntimeError as e:
        pytest.fail(str(e))


def _single(job, dispatched=None):
    """The port's single-process encode of the job's clip (labels: fixed
    depth 1, or the port's ConvNet2 from init_params(0)); the on-device
    dict before collect() goes into `dispatched` when one is given."""
    from hevctpu_torch.models import convnet2
    y, u, v = _clip(job["b"], job["h"], job["w"], job["seed"])
    enc = E.FrameEncoder(job["h"], job["w"], job["qp"],
                         device=job.get("device", "cpu"))
    g = enc.geom
    if job["cnn"]:
        labels = convnet2.predict_frame_labels(
            convnet2.load_model(convnet2.init_params(0), "cpu"),
            *(torch.as_tensor(p) for p in (y, u, v)), job["h"],
            job["w"]).numpy().astype(np.int8)
    else:
        labels = np.ones((job["b"], g.rc * g.cc, 16), np.int8)
    dev_out = enc.encode_dispatch(y, u, v, labels)
    if dispatched is not None:
        dispatched.update(dev_out)
    out = enc.collect(dev_out)
    out["labels"] = labels
    return out


def spawn_and_encode(job):
    """run_world and _single of one job, each rank's result holding the
    closed form of its tally under "closed_form"."""
    from hevctpu_torch.parallel.sharded import tally_closed_form
    ranks = run_world(job)
    dispatched = {}
    single = _single(job, dispatched)
    for res in ranks.values():
        res["closed_form"] = tally_closed_form(
            job["h"], job["w"], (res["shape"]["frame"], res["shape"]["tile"]),
            res["coords"][1], job["b"], dispatched)
    return ranks, single


@pytest.fixture(scope="module")
def fixed_world():
    return spawn_and_encode(FIXED)


@pytest.fixture(scope="module")
def cnn_world():
    return spawn_and_encode(CNN)


def _assert_same(got: dict, want: dict, keys, what: str):
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert np.array_equal(a, b), f"{what}: {k} differs"


@pytest.mark.parametrize("key", COMPARED)
def test_frame_and_tile_sharded_matches_single_process(fixed_world, key):
    """(frame=2, tile=2) world, 128x128 x 4, fixed depth 1, QP 32: every
    rank returns the whole batch, equal key by key."""
    ranks, single = fixed_world
    assert sorted(ranks) == [0, 1, 2, 3]
    for rank, res in ranks.items():
        _assert_same(res["out"], single, [key], f"rank {rank}")


def test_sharded_dict_is_the_single_process_dict(fixed_world, cnn_world):
    """Same keys, dtypes and values, labels int8 and the sbh marker
    included, on every rank of both worlds."""
    for ranks, single in (fixed_world, cnn_world):
        for rank, res in ranks.items():
            assert set(res["out"]) == set(single) | {"sbh"}
            _assert_same(res["out"], single, sorted(single), f"rank {rank}")
            assert res["out"]["labels"].dtype == np.int8
            assert res["out"]["sbh"] == np.bool_(True)


def test_cnn_labels_tile_sharded_match(cnn_world):
    """(1, 2) world, 64x128 x 4, ConvNet2 init_params(0), QP 37: the
    labels and tests/test_sharded.py's keys on both ranks."""
    ranks, single = cnn_world
    for rank, res in ranks.items():
        _assert_same(res["out"], single,
                     ["labels", "recon_y", "levels_y", "depth8", "mode4"],
                     f"rank {rank}")


def test_without_halo_exchange_matches(cnn_world):
    """halo_exchange=False: every tile rank encodes the full width; the
    same dict."""
    ranks, single = cnn_world
    for rank, res in ranks.items():
        _assert_same(res["no_halo"], single, sorted(single), f"rank {rank}")


# (world, halo calls, halo bytes a rank, width-gather bytes a rank): 2
# frames a rank of 2 x 2 CTUs, 3 exchanges of [2, 2, 128] int32 from the
# one neighbour; 4 frames a rank of 1 x 2 CTUs, 1 exchange of [4, 1, 128];
# the 13 stage-2 outputs at 49,984 bytes a CTU a frame
TALLIES = [("fixed", 3, 3 * 2048, 2 * 4 * 49984),
           ("cnn", 1, 2048, 4 * 2 * 49984)]


@pytest.mark.parametrize("world,calls,halo,width", TALLIES)
def test_tally_equals_closed_form(request, world, calls, halo, width):
    """Each rank's tally of its encode: the closed form of the geometry
    (tally_closed_form), here the halo exchanges and the width gather
    reckoned by hand; the frame gather of the (2, 2) world is the whole
    dict's bytes, 2 x each rank's piece; none in the (1, 2) world."""
    ranks, single = request.getfixturevalue(f"{world}_world")
    for rank, res in ranks.items():
        got = res["tally"]
        assert got == res["closed_form"], f"rank {rank}"
        assert got["halo"]["tile"] == dict(calls=calls, bytes=halo,
                                           sent=halo, received=halo)
        assert got["all-gather"]["tile"]["calls"] == 13
        assert got["all-gather"]["tile"]["bytes"] == width
        assert got["all-gather"]["tile"]["received"] == width // 2
        frames = got["all-gather"].get("frame")
        if res["shape"]["frame"] == 1:
            assert frames is None
        else:
            # every key but the host's sbh marker
            assert frames["calls"] == len(single) - 1
            assert frames["bytes"] == 2 * frames["sent"]


def test_meshes_of_the_worlds(fixed_world, cnn_world):
    """make_mesh's default factorization over a world of 4 and of 2, and
    the ranks' coordinates (rank = frame * tile + tile index)."""
    for (ranks, _), shape in ((fixed_world, {"frame": 2, "tile": 2}),
                              (cnn_world, {"frame": 1, "tile": 2})):
        for rank, res in ranks.items():
            assert res["shape"] == shape
            assert res["coords"] == divmod(rank, shape["tile"])


def test_refusals_under_tiles(fixed_world, cnn_world):
    """CTU columns that do not divide into the tiles, a per-CTU QP map
    under tile sharding, and a batch that does not divide over the frame
    axis are refused on every rank."""
    for res in cnn_world[0].values():
        assert "do not divide into 2 tiles" in res["cc_refused"]
        assert "QP maps are not supported" in res["qp_map_refused"]
    for res in fixed_world[0].values():
        assert "does not divide over 2 frame ranks" in res["batch_refused"]


@pytest.mark.gpu
def test_nccl_world_of_one_matches_single_process():
    """One NCCL rank, mesh (1, 1), on the card: the fixed-depth fixture
    equal to the single-process encode on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL has no CPU transport")
    job = dict(FIXED, world=1, backend="nccl", device="cuda")
    ranks = run_world(job)
    assert ranks[0]["shape"] == {"frame": 1, "tile": 1}
    single = _single(job)
    _assert_same(ranks[0]["out"], single, sorted(single), "NCCL rank 0")


@pytest.mark.parametrize("src", [dict(), dict(cnn_params={}, fixed_depth=1)])
def test_exactly_one_label_source(src):
    from hevctpu_torch.parallel import ShardedEncoder, make_mesh
    with pytest.raises(ValueError, match="exactly one"):
        ShardedEncoder(64, 128, 32, make_mesh(), device="cpu", **src)


def test_default_device_is_the_card():
    from hevctpu_torch.parallel import ShardedEncoder, make_mesh
    if torch.cuda.is_available():
        pytest.skip("the rule under test is the one without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedEncoder(64, 128, 32, make_mesh(), fixed_depth=1)
    assert ShardedEncoder(64, 128, 32, make_mesh(), fixed_depth=1,
                          device="cpu").enc.device == torch.device("cpu")


def test_make_mesh_shapes():
    """tests/test_sharded.py::test_make_mesh_shapes on the port: the
    factorization invariants, and one rank without a process group."""
    from hevctpu_torch.parallel import make_mesh
    from hevctpu_torch.parallel.sharded import mesh_shape
    frame, tile = mesh_shape(2)
    assert frame * tile == 2
    assert mesh_shape(1) == (1, 1) and mesh_shape(3) == (3, 1)
    assert mesh_shape(4) == (2, 2) and mesh_shape(8, tile=4) == (2, 4)
    with pytest.raises(ValueError):
        mesh_shape(4, tile=3)
    m1 = make_mesh()
    assert m1.shape == {"frame": 1, "tile": 1}
    assert m1.frame_group is None and m1.tile_group is None


@pytest.mark.parametrize("hw,tiles", [((256, 512), 1), ((256, 512), 2),
                                      ((256, 512), 4), ((1088, 1920), 2),
                                      ((1088, 1920), 3), ((1088, 1920), 5)])
def test_wavefront_tiled_equals_reference(hw, tiles):
    from hevctpu.pipeline.encoder import Geometry as JaxGeometry
    want = JaxGeometry(*hw).wavefront_tiled(tiles)
    got = E.Geometry(*hw).wavefront_tiled(tiles)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_wavefront_tiled_tables():
    """tests/test_sharded.py::test_wavefront_tiled_tables on the port: the
    per-tile tables partition the global wavefront exactly, tile-local
    column ranges, and the per-tile occupancy bound."""
    g = E.Geometry(4 * 64, 8 * 64)
    gr, gc, gm = g.wavefront
    for tiles in (1, 2, 4):
        tr, tc, tm = g.wavefront_tiled(tiles)
        assert tr.shape[0] == tiles and tr.shape[1] == gr.shape[0]
        cl = g.cc // tiles
        cells_g = {(d, r, c) for d in range(gr.shape[0])
                   for r, c, m in zip(gr[d], gc[d], gm[d]) if m}
        cells_t = set()
        for t in range(tiles):
            for d in range(tr.shape[1]):
                for r, c, m in zip(tr[t, d], tc[t, d], tm[t, d]):
                    if m:
                        assert t * cl <= c < (t + 1) * cl
                        cells_t.add((d, int(r), int(c)))
        assert cells_t == cells_g
    assert g.wavefront_tiled(4)[0].shape[2] <= g.wavefront[0].shape[1]
    with pytest.raises(ValueError):
        g.wavefront_tiled(3)


def _plan_cells(geom, tz, c8, tiles, t):
    """{(diagonal, frame, r, global c, size, oy, ox, luma?): availability
    bytes} of every firing (CTU, TU step) in tile t's stage-2 plan."""
    cl = geom.cc // tiles
    up = E._Upload()
    own = slice(t * cl, (t + 1) * cl)
    plan = E._stage2_plan(geom, tuple(x[t] for x in geom.wavefront_tiled(
        tiles)), tz[:, :, own], c8[:, :, own], up, t * cl)
    up.upload(torch.device("cpu"))
    cells = {}
    for d, (idx, steps) in enumerate(plan):
        bi, r, c = (x.numpy() for x in up.get(idx))
        ctus = list(zip(bi, r, c + t * cl))
        for n, oy, ox, lstep, cstep in steps:
            for luma, step in ((True, lstep), (False, cstep)):
                if step is None:
                    continue
                fire, av = (up.get(h).numpy() for h in step)
                rows = ctus if luma else ctus * 2    # chroma: U rows, V rows
                for i, ctu in enumerate(rows):
                    if fire[i]:
                        cells[(d, *map(int, ctu), n, oy, ox, luma,
                               i >= len(ctus))] = av[i].tobytes()
    return cells


@pytest.mark.parametrize("tiles", [2, 3])
def test_tile_plans_are_the_union_of_their_ctus_steps(tiles):
    """Each tile plans only its own CTUs, and the tiles' plans together
    fire exactly the single-device plan's (CTU, TU step) pairs with the
    same availability: a smaller union of steps per diagonal, the same
    masked work."""
    geom = E.Geometry(200, 384)                 # 4 x 6 CTUs, a partial row
    rng = np.random.default_rng(0)
    shape = (2, geom.rc, geom.cc, 8, 8)
    tz = rng.integers(2, 6, shape).astype(np.int32)
    c8 = rng.random(shape) < 0.9
    whole = _plan_cells(geom, tz, c8, 1, 0)
    parts = [_plan_cells(geom, tz, c8, tiles, t) for t in range(tiles)]
    cl = geom.cc // tiles
    for t, part in enumerate(parts):
        assert all(t * cl <= key[3] < (t + 1) * cl for key in part)
    union = {k: v for part in parts for k, v in part.items()}
    assert sum(len(p) for p in parts) == len(union)
    assert union == whole
