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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from hevctpu_torch.models import convnet2
from hevctpu_torch.pipeline.encoder import FrameEncoder


def mesh_shape(n: int, tile: int | None = None) -> tuple[int, int]:
    """(frame, tile) of n ranks: tile = 2 when n is even and above 1
    unless given, frame = n // tile."""
    if tile is None:
        tile = 2 if n % 2 == 0 and n > 1 else 1
    if tile < 1 or n % tile:
        raise ValueError(f"{n} ranks do not form tiles of {tile}")
    return n // tile, tile


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (frame, tile) grid over the ranks of a torch.distributed world,
    rank = frame_index * tile + tile_index: this rank's coordinates and
    the process groups of its frame axis (the ranks of its tile index)
    and of its tile axis (the ranks of its frame index). A mesh of one
    rank without a process group has no groups and communicates
    nothing."""
    frame: int
    tile: int
    frame_index: int = 0
    tile_index: int = 0
    frame_group: object = None
    tile_group: object = None

    @property
    def shape(self) -> dict:
        return {"frame": self.frame, "tile": self.tile}

    @property
    def rank(self) -> int:
        return self.frame_index * self.tile + self.tile_index

    def exchange(self, right: torch.Tensor, bottom: torch.Tensor):
        """The halo exchange of one diagonal along the tile axis: send
        `right` to tile t+1 and `bottom` to tile t-1; returns (what tile
        t-1 sent, what tile t+1 sent), zeros where there is no such
        tile. Every rank of the tile group must call it."""
        host = dist.get_backend(self.tile_group) == "gloo"
        sends = [x.cpu() if host else x.contiguous() for x in (right, bottom)]
        from_l, from_r = (torch.zeros_like(x) for x in sends)
        base = self.frame_index * self.tile
        ops = []
        if self.tile_index + 1 < self.tile:
            peer = base + self.tile_index + 1
            ops += [dist.P2POp(dist.isend, sends[0], peer, self.tile_group),
                    dist.P2POp(dist.irecv, from_r, peer, self.tile_group)]
        if self.tile_index > 0:
            peer = base + self.tile_index - 1
            ops += [dist.P2POp(dist.isend, sends[1], peer, self.tile_group),
                    dist.P2POp(dist.irecv, from_l, peer, self.tile_group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return from_l.to(right.device), from_r.to(right.device)

    def gather_width(self, t: torch.Tensor) -> torch.Tensor:
        """The tile group's [..., W / tile] pieces joined along the last
        axis, in tile order."""
        return _all_gather(t, self.tile_group, -1)

    def gather_frames(self, t: torch.Tensor) -> torch.Tensor:
        """The frame group's [B / frame, ...] pieces joined along the
        first axis, in frame order."""
        return _all_gather(t, self.frame_group, 0)


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """all_gather of equal-shaped tensors of any dtype (moved as bytes)
    over group, joined along dim; t itself without a group."""
    if group is None:
        return t
    host = dist.get_backend(group) == "gloo"
    buf = t.contiguous().reshape(-1).view(torch.uint8)
    buf = buf.cpu() if host else buf
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
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
        (int8); equal to FrameEncoder.encode(y, u, v, labels)."""
        m, enc = self.mesh, self.enc
        b = np.shape(y)[0]
        if b % m.frame:
            raise ValueError(f"a batch of {b} frames does not divide over "
                             f"{m.frame} frame ranks")
        per = b // m.frame
        own = slice(m.frame_index * per, (m.frame_index + 1) * per)
        y, u, v = (np.asarray(p)[own] for p in (y, u, v))
        if self.cnn is not None:
            out = enc.encode_fused_dispatch(self.cnn, y, u, v)
        else:
            g = enc.geom
            labels = np.full((per, g.rc * g.cc, 16), self.fixed_depth,
                             np.int8)
            out = enc.encode_dispatch(y, u, v, labels)
            out["labels"] = torch.as_tensor(labels).to(enc.device)
        return enc.collect({k: m.gather_frames(t) for k, t in out.items()})
