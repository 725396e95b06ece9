"""Multi-device encoding over torch.distributed (port of
hevctpu/parallel/sharded.py).

  frame axis — data parallel over the frame batch. All-Intra frames are
      independent, so each rank encodes its own frames and the results
      are gathered at the end.
  tile axis — CTU columns split over the ranks of a tile group. Stage 1
      (the dense mode decision), the loop filters, checksums and SSE run
      over the full width on every rank of the group (they are a few
      percent of an encode); stage 2, the wavefront, runs per tile
      (FrameEncoder._reconstruct(shard=...)), the left / above-left /
      above-right recon dependencies carried by point-to-point halo
      exchanges after every diagonal, and its outputs are gathered along
      the width before the filters.

The transport is the backend of the process group the caller initialized
(dist.get_backend): NCCL takes the device tensors, one rank per card;
gloo takes host tensors only, so halos and gathered outputs are copied
through the host around each collective while the compute stays on the
rank's device.

Each Mesh tallies the bytes of its collectives as they move (the
counterpart of the HLO walk in tools/scaling_model.py; tally_closed_form
is what one encode must move, from the geometry alone).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from hevctpu_torch.models import convnet2
from hevctpu_torch.pipeline.encoder import FrameEncoder, Geometry


def mesh_shape(n: int, tile: int | None = None) -> tuple[int, int]:
    """(frame, tile) of n ranks: tile = 2 when n is even and above 1
    unless given, frame = n // tile."""
    if tile is None:
        tile = 2 if n % 2 == 0 and n > 1 else 1
    if tile < 1 or n % tile:
        raise ValueError(f"{n} ranks do not form tiles of {tile}")
    return n // tile, tile


# the ops of the tally: the halo exchange is the JAX program's
# collective-permute
HALO, ALL_GATHER = "halo", "all-gather"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (frame, tile) grid over the ranks of a torch.distributed world,
    rank = frame_index * tile + tile_index: this rank's coordinates and
    the process groups of its frame axis (the ranks of its tile index)
    and of its tile axis (the ranks of its frame index). A mesh of one
    rank without a process group has no groups and communicates
    nothing.

    The mesh tallies this rank's collectives (see `tally`): calls and
    bytes by op (HALO, ALL_GATHER) and axis ("tile", "frame"), counted
    as tools/scaling_model.py counts HLO collectives, by their output
    bytes on this rank: for an exchange the bytes received, for an
    all-gather the group size times the piece. Beside them, the bytes
    this rank sent to and received from other ranks. gloo's copies
    between the device and the host are no collective and are not
    counted, nor is a collective over a group of one rank, which moves
    nothing."""
    frame: int
    tile: int
    frame_index: int = 0
    tile_index: int = 0
    frame_group: object = None
    tile_group: object = None
    _tally: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def shape(self) -> dict:
        return {"frame": self.frame, "tile": self.tile}

    @property
    def rank(self) -> int:
        return self.frame_index * self.tile + self.tile_index

    @property
    def tally(self) -> dict:
        """A copy of the tally since the mesh was made or last reset:
        {op: {axis: {"calls", "bytes", "sent", "received"}}}."""
        out = {}
        for (op, axis), c in sorted(self._tally.items()):
            out.setdefault(op, {})[axis] = dict(c)
        return out

    def reset_tally(self):
        self._tally.clear()

    def _count(self, op: str, axis: str, out: int, sent: int,
               received: int):
        c = self._tally.setdefault((op, axis), dict(
            calls=0, bytes=0, sent=0, received=0))
        c["calls"] += 1
        c["bytes"] += out
        c["sent"] += sent
        c["received"] += received

    def exchange(self, right: torch.Tensor, bottom: torch.Tensor):
        """The halo exchange of one diagonal along the tile axis: send
        `right` to tile t+1 and `bottom` to tile t-1; returns (what tile
        t-1 sent, what tile t+1 sent), zeros where there is no such
        tile. Every rank of the tile group must call it."""
        host = dist.get_backend(self.tile_group) == "gloo"
        sends = [x.cpu() if host else x.contiguous() for x in (right, bottom)]
        from_l, from_r = (torch.zeros_like(x) for x in sends)
        base = self.frame_index * self.tile
        ops, sent, received = [], 0, 0
        if self.tile_index + 1 < self.tile:
            peer = base + self.tile_index + 1
            ops += [dist.P2POp(dist.isend, sends[0], peer, self.tile_group),
                    dist.P2POp(dist.irecv, from_r, peer, self.tile_group)]
            sent += sends[0].nbytes
            received += from_r.nbytes
        if self.tile_index > 0:
            peer = base + self.tile_index - 1
            ops += [dist.P2POp(dist.isend, sends[1], peer, self.tile_group),
                    dist.P2POp(dist.irecv, from_l, peer, self.tile_group)]
            sent += sends[1].nbytes
            received += from_l.nbytes
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self._count(HALO, "tile", received, sent, received)
        return from_l.to(right.device), from_r.to(right.device)

    def gather_width(self, t: torch.Tensor) -> torch.Tensor:
        """The tile group's [..., W / tile] pieces joined along the last
        axis, in tile order."""
        return self._all_gather(t, self.tile_group, "tile", -1)

    def gather_frames(self, t: torch.Tensor) -> torch.Tensor:
        """The frame group's [B / frame, ...] pieces joined along the
        first axis, in frame order."""
        return self._all_gather(t, self.frame_group, "frame", 0)

    def _all_gather(self, t: torch.Tensor, group, axis: str,
                    dim: int) -> torch.Tensor:
        """all_gather of equal-shaped tensors of any dtype (moved as
        bytes) over group, joined along dim; t itself without a group."""
        if group is None:
            return t
        host = dist.get_backend(group) == "gloo"
        buf = t.contiguous().reshape(-1).view(torch.uint8)
        buf = buf.cpu() if host else buf
        n = dist.get_world_size(group)
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=group)
        if n > 1:
            self._count(ALL_GATHER, axis, n * buf.nbytes,
                        (n - 1) * buf.nbytes, (n - 1) * buf.nbytes)
        return torch.cat([p.to(t.device).view(t.dtype).reshape(t.shape)
                          for p in parts], dim=dim)


def make_mesh(tile: int | None = None) -> Mesh:
    """The (frame, tile) mesh of the initialized torch.distributed world
    (mesh_shape's factorization), or a mesh of one rank without one.
    Collective: every rank creates every axis group, in the same order."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(*mesh_shape(1, tile))
    frame, tile = mesh_shape(dist.get_world_size(), tile)
    frame_groups = [dist.new_group([f * tile + t for f in range(frame)])
                    for t in range(tile)]
    tile_groups = [dist.new_group([f * tile + t for t in range(tile)])
                   for f in range(frame)]
    f, t = divmod(dist.get_rank(), tile)
    return Mesh(frame, tile, f, t, frame_groups[t], tile_groups[f])


class ShardedEncoder:
    """CNN depth labels (or a fixed depth) + the full frame encode on a
    (frame, tile) mesh; every rank of the world constructs one and calls
    encode with the same batch.

    The batch must be a multiple of the frame axis; each rank encodes its
    B / frame frames. With halo_exchange and more than one tile, stage 2
    runs per tile (cc must divide into the tiles); without it, every rank
    of a tile group encodes the full width, as the reference's GSPMD
    program does without explicit halos, to the same outputs. The device
    defaults to this rank's card (rank modulo the cards) and raises
    without CUDA unless device="cpu" is given. cnn_params are JAX-layout
    ConvNet2 params (models.checkpoint.load)."""

    def __init__(self, h: int, w: int, qp: int, mesh: Mesh,
                 cnn_params: dict | None = None,
                 fixed_depth: int | None = None,
                 halo_exchange: bool = True, device=None):
        if (cnn_params is None) == (fixed_depth is None):
            raise ValueError("pass exactly one of cnn_params / fixed_depth")
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda",
                                  mesh.rank % torch.cuda.device_count())
        self.enc = FrameEncoder(h, w, qp, device=device)
        if halo_exchange and mesh.tile > 1:
            if self.enc.geom.cc % mesh.tile:
                raise ValueError(f"{self.enc.geom.cc} CTU columns do not "
                                 f"divide into {mesh.tile} tiles")
            self.enc.shard = mesh
        self.mesh = mesh
        self.cnn = (None if cnn_params is None
                    else convnet2.load_model(cnn_params, self.enc.device))
        self.fixed_depth = fixed_depth

    def encode(self, y, u, v) -> dict:
        """y [B,H,W], u/v [B,H/2,W/2] -> on every rank, the whole batch's
        dict of numpy arrays (FrameEncoder.encode's keys) plus the labels
        (int8); equal to FrameEncoder.encode(y, u, v, labels).

        Every key's frames are gathered onto every rank of the frame axis
        at the end (gather_frames): bytes the JAX program, whose outputs
        stay sharded, does not move.

        Stage 2's tile collectives (halo exchanges, the width gather) run
        on the encoder's dispatch worker, one thread a rank, so every
        rank calls them in the same order; this waits for the dispatch
        before the frame gather, which runs on the caller's thread."""
        m, enc = self.mesh, self.enc
        b = np.shape(y)[0]
        if b % m.frame:
            raise ValueError(f"a batch of {b} frames does not divide over "
                             f"{m.frame} frame ranks")
        per = b // m.frame
        own = slice(m.frame_index * per, (m.frame_index + 1) * per)
        y, u, v = (np.asarray(p)[own] for p in (y, u, v))
        if self.cnn is not None:
            out = enc.encode_fused_dispatch(self.cnn, y, u, v).result()
        else:
            g = enc.geom
            labels = np.full((per, g.rc * g.cc, 16), self.fixed_depth,
                             np.int8)
            out = enc.encode_dispatch(y, u, v, labels).result()
            out["labels"] = torch.as_tensor(labels).to(enc.device)
        return enc.collect({k: m.gather_frames(t) for k, t in out.items()})


# Bytes one CTU of one frame adds to the 13 stage-2 outputs that a tile
# group gathers along the width (FrameEncoder._reconstruct): recon and
# levels, int32, at 64x64 (Y) and 32x32 (U, V); cbf_y/u/v and ts8_u/v,
# bool, at 8x8; cbf4_y and ts4_y, bool, at 16x16.
STAGE2_OUTPUTS = 13
STAGE2_BYTES_PER_CTU = (2 * (64 * 64 + 2 * 32 * 32) * 4 + 5 * 8 * 8
                        + 2 * 16 * 16)
# int32 words a CTU row of a halo payload holds: Y, U and V edges
HALO_WORDS = 64 + 32 + 32


def tally_closed_form(h: int, w: int, mesh_shape: tuple, tile_index: int,
                      frames: int, out: dict) -> dict:
    """The tally (Mesh.tally's layout) one rank at tile_index of a
    (frame, tile) mesh holds after one ShardedEncoder.encode of `frames`
    frames of h x w with the halo exchange on, from the geometry alone.

    Tile axis (tile > 1): an exchange after every diagonal but the
    first, 2(rc - 1) + cc - 1 of them, each a [B/frame, rc, HALO_WORDS]
    int32 payload from each neighbour (one at an edge tile, two in the
    middle); the 13 stage-2 outputs gathered along the width. Frame axis
    (frame > 1): every tensor of the output dict gathered. out is the
    on-device output dict of the whole batch, as
    FrameEncoder.encode_dispatch returns it (the labels, [B, rc*cc, 16]
    int8, are counted whether it holds them or not)."""
    frame, tile = mesh_shape
    g = Geometry(h, w)
    per = frames // frame
    tally = {}

    def put(op, axis, calls, nbytes, moved):
        tally.setdefault(op, {})[axis] = dict(
            calls=calls, bytes=nbytes, sent=moved, received=moved)

    if tile > 1:
        calls = 2 * (g.rc - 1) + g.cc - 1
        peers = (tile_index > 0) + (tile_index < tile - 1)
        halo = calls * peers * per * g.rc * HALO_WORDS * 4
        put(HALO, "tile", calls, halo, halo)
        width = per * g.rc * g.cc * STAGE2_BYTES_PER_CTU
        put(ALL_GATHER, "tile", STAGE2_OUTPUTS, width,
            width // tile * (tile - 1))
    if frame > 1:
        sizes = {k: t.numel() * t.element_size() for k, t in out.items()}
        sizes.setdefault("labels", frames * g.rc * g.cc * 16)
        total = sum(sizes.values())
        put(ALL_GATHER, "frame", len(sizes), total,
            total // frame * (frame - 1))
    return {op: dict(sorted(axes.items()))
            for op, axes in sorted(tally.items())}
