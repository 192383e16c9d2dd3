"""A mesh of shards over devices and ``torch.distributed``.

Ports ``parallel/sharded.py:make_mesh`` (36), the point-axis specs of its
``shard_map`` calls (``_pt_specs`` 48) and the two collectives the
reference's per-shard bodies use: ``jax.lax.all_gather`` over the mesh
axis, and the XOR-partner ``jax.lax.ppermute`` of
``fft_dist._cross_stage`` (151).

One mesh type serves both of the reference's models.  A mesh holds D
global shards; this process owns ``local`` of them, each on a
``torch.device``.  With a ``torch.distributed`` process group of ``world``
ranks, D = world x local and rank k owns shards [k local, (k + 1) local).
One process with D local shards is the counterpart of the virtual
8-device mesh and of ``dryrun_multichip``; two processes of four local
shards each is the counterpart of ``scripts/multihost_dryrun.py``.

A shard is a slice of a global tensor along one axis: shard g of n rows
holds rows [g n/D, (g + 1) n/D).  A partner in this process gets a
``.to(device)`` copy (a peer copy between cards, a view on one card); a
partner in another process goes through the group:

  * ``gloo`` carries host tensors, so the exchanges of CUDA shards are
    staged through host memory (transport ``gloo-host``; the mesh says so
    on stderr when it is built);
  * ``nccl`` carries device tensors directly (transport ``nccl``); each
    rank talks through the card of its first shard, and NCCL refuses two
    ranks on one card, so the mesh refuses that too.

Several shards on one card are the caller's explicit choice
(``make_mesh(4, devices=["cuda:0"] * 4)``), never a stand-in for missing
cards: with no devices given, the mesh takes one card a shard and raises
when there are too few.  CPU shards (``devices=["cpu"] * D``) run the
plain versions and serve the tests.
"""

from __future__ import annotations

import sys
from typing import Sequence

import torch
import torch.distributed as dist


class Mesh:
    """D shards: ``devices`` are this process's, ``group`` (or None) joins
    the processes.  ``size`` is D, ``local`` the shards of this process,
    ``first`` the global index of its first shard."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("mesh: no devices")
        self.local = len(self.devices)
        self.group = group
        if group is None:
            self.world, self.rank = 1, 0
            self.transport = "local"
            self.comm_device = None
        else:
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            backend = dist.get_backend(group)
            if backend == "gloo":
                self.transport = "gloo-host"
                self.comm_device = torch.device("cpu")
            elif backend == "nccl":
                self.transport = "nccl"
                self.comm_device = self.devices[0]
                self._check_nccl_cards()
            else:
                raise ValueError(f"mesh: backend {backend!r} not in "
                                 "('gloo', 'nccl')")
        self.size = self.world * self.local
        self.first = self.rank * self.local
        if self.transport == "gloo-host" and any(
                d.type == "cuda" for d in self.devices):
            print(f"mesh: {self.describe()}: gloo carries host tensors, so "
                  "the exchanges of the cuda shards are staged through host "
                  "memory", file=sys.stderr, flush=True)

    def _check_nccl_cards(self) -> None:
        if self.comm_device.type != "cuda":
            raise ValueError("mesh: an nccl group needs cuda shards")
        cards = [None] * self.world
        dist.all_gather_object(cards, self.comm_device.index, self.group)
        if len(set(cards)) != len(cards):
            raise RuntimeError(
                f"mesh: ranks talk through cards {cards}; NCCL refuses two "
                "ranks on one GPU (use gloo, or one card a rank)")

    def describe(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        procs = (f"{self.world} processes x {self.local}, rank {self.rank}"
                 if self.group is not None else "1 process")
        return (f"{self.size} shards ({procs}) on [{names}], transport "
                f"{self.transport}")

    # -- layout -------------------------------------------------------------
    def shard_ids(self) -> range:
        return range(self.first, self.first + self.local)

    def shard(self, x, axis: int = 0) -> list:
        """A global tensor -> this process's shards along ``axis``, each on
        its device; a list of local shards is returned as it is."""
        if isinstance(x, (list, tuple)):
            if len(x) != self.local:
                raise ValueError(f"mesh: {len(x)} shards for {self.local} "
                                 "local ones")
            return list(x)
        n = x.shape[axis]
        if n % self.size:
            raise ValueError(f"mesh: {n} rows do not divide into "
                             f"{self.size} shards")
        s = n // self.size
        return [x.narrow(axis, g * s, s).to(d)
                for g, d in zip(self.shard_ids(), self.devices)]

    def gather(self, xs: Sequence, axis: int = 0) -> torch.Tensor:
        """Every shard's tensor, concatenated along ``axis`` in shard order,
        on this process's first device."""
        return torch.cat(list(self.all_gather(xs)[0].unbind(0)), dim=axis)

    # -- collectives --------------------------------------------------------
    def all_gather(self, xs: Sequence) -> list:
        """Each local shard's tensor (one shape for all) -> for each local
        shard, the (D, ...) stack of every shard's tensor on its device."""
        xs = self._check(xs)
        if self.group is None:
            every = torch.stack([x.to(self.devices[0]) for x in xs])
        else:
            mine = torch.stack([x.to(self.comm_device) for x in xs])
            parts = [torch.empty_like(mine) for _ in range(self.world)]
            dist.all_gather(parts, mine.contiguous(), group=self.group)
            every = torch.cat(parts)
        # one copy a device: shards that share a card share the stack
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = every.to(d)
        return [copies[d] for d in self.devices]

    def exchange(self, xs: Sequence, distance: int) -> list:
        """Each local shard g gets the tensor of shard g ^ distance (the
        XOR-partner ``ppermute``), on its own device."""
        xs = self._check(xs)
        if distance < 1 or distance >= self.size or \
                self.size & (self.size - 1):
            raise ValueError(f"mesh: exchange at distance {distance} over "
                             f"{self.size} shards (a power of two)")
        out, remote = [None] * self.local, []
        for i, (g, d) in enumerate(zip(self.shard_ids(), self.devices)):
            p = g ^ distance
            if self.first <= p < self.first + self.local:
                out[i] = xs[p - self.first].to(d)
            else:
                remote.append((i, p // self.local))
        if remote:
            ops, bufs = [], []
            for i, peer in remote:
                send = xs[i].to(self.comm_device).contiguous()
                buf = torch.empty_like(send)
                ops.append(dist.P2POp(dist.isend, send, peer, self.group,
                                      tag=i))
                ops.append(dist.P2POp(dist.irecv, buf, peer, self.group,
                                      tag=i))
                bufs.append((i, buf))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for i, buf in bufs:
                out[i] = buf.to(self.devices[i])
        return out

    def _check(self, xs: Sequence) -> list:
        xs = list(xs)
        if len(xs) != self.local:
            raise ValueError(f"mesh: {len(xs)} tensors for {self.local} "
                             "local shards")
        return xs


def make_mesh(n_devices: int | None = None, devices: Sequence | None = None,
              group=None) -> Mesh:
    """A mesh of ``n_devices`` shards in all (``sharded.make_mesh`` 36).

    ``devices``: this process's shards (several may name one card, or
    "cpu"); with none given, one card a shard -- cuda:k local + i for
    local shard i of rank k -- and a RuntimeError when there are too few.
    ``group``: a ``torch.distributed`` group joining the processes, each
    with n_devices / world shards."""
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if devices is None:
        if n_devices is None:
            raise ValueError("make_mesh: give n_devices or devices")
        if n_devices % world:
            raise ValueError(f"make_mesh: {n_devices} shards over {world} "
                             "processes")
        local = n_devices // world
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"make_mesh({n_devices}): one card a shard needs "
                f"{n_devices} CUDA devices, this machine has {have}; pass "
                "devices=[...] to put several shards on one card (or on "
                "the CPU)")
        devices = [f"cuda:{rank * local + i}" for i in range(local)]
    mesh = Mesh(devices, group)
    if n_devices is not None and mesh.size != n_devices:
        raise ValueError(f"make_mesh: {n_devices} shards asked for, "
                         f"{mesh.size} given ({mesh.describe()})")
    return mesh
