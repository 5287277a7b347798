"""The node's handoff: its assembler's slots to the other ranks of the node.

One rank of each node, its local rank 0 (the assembler), tensorizes,
assembles and finalizes the node's minibatches; it sends every other rank
of the node that rank's slot (or shard) of each group over a gloo group of
the node's ranks, as CPU tensors, so that NCCL stays free for the steps.

A message is two point-to-point sends: a header of four int64 (its kind,
the blob's bytes, the pickle's bytes, the count of out-of-band buffers),
then the blob: a table of each buffer's (offset, bytes), the object pickled
with protocol 5 (its numpy arrays out of band), then each buffer at an
offset aligned to 64 bytes. The receiver's arrays are views of the blob it
received: the bytes, dtypes and shapes of the sender's."""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ptgnn_tpu_torch.utils import tracing

__all__ = ["NodeHandoff", "node_local_group", "pack", "unpack", "SLOT", "END", "ERROR"]

SLOT, END, ERROR = 0, 1, 2  # a message's kind
_ALIGN = 64


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def pack(obj: Any) -> Tuple[int, int, np.ndarray]:
    """(pickle bytes, buffer count, blob) of ``obj``."""
    buffers: List[pickle.PickleBuffer] = []
    head = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    raws = [b.raw() for b in buffers]
    table = np.empty((len(raws), 2), np.int64)
    offset = _aligned(table.nbytes + len(head))
    for i, raw in enumerate(raws):
        table[i] = offset, raw.nbytes
        offset = _aligned(offset + raw.nbytes)
    blob = np.empty(offset, np.uint8)
    blob[:table.nbytes] = table.reshape(-1).view(np.uint8)
    blob[table.nbytes:table.nbytes + len(head)] = np.frombuffer(head, np.uint8)
    for (start, size), raw in zip(table.tolist(), raws):
        blob[start:start + size] = np.frombuffer(raw, np.uint8)
    return len(head), len(raws), blob


def unpack(blob: np.ndarray, head_bytes: int, num_buffers: int) -> Any:
    """The object of :func:`pack`'s blob; its arrays are views of ``blob``."""
    table = blob[:16 * num_buffers].view(np.int64).reshape(num_buffers, 2)
    head = blob[16 * num_buffers:16 * num_buffers + head_bytes]
    return pickle.loads(memoryview(head), buffers=[memoryview(blob[s:s + n]) for s, n in table.tolist()])


def node_local_group(local_world_size: int) -> Tuple[Optional[Any], List[int]]:
    """(this rank's gloo group of its node's ranks, their global ranks):
    every node's group is made on every rank, in the same order. None at
    one rank a node."""
    world, rank = dist.get_world_size(), dist.get_rank()
    node = rank // local_world_size
    mine: Optional[Any] = None
    for n in range(world // local_world_size):
        ranks = list(range(n * local_world_size, (n + 1) * local_world_size))
        group = dist.new_group(ranks, backend="gloo") if local_world_size > 1 else None
        if n == node:
            mine = group
    return mine, list(range(node * local_world_size, (node + 1) * local_world_size))


class NodeHandoff:
    """Messages between the assembler (``ranks[0]``) and the other ranks of
    a node over ``group``. ``stats`` counts this rank's slot messages: sent
    or received, their blob bytes, the host seconds in the calls
    (``seconds``: waits for the other side included) and, of those, the
    seconds packing or unpacking (``pack_seconds``): the spans
    ``ptgnn.handoff.send`` / ``receive`` and ``ptgnn.handoff.pack`` /
    ``unpack`` (``utils/tracing.py``), which count every message."""

    def __init__(self, group: Any, ranks: Sequence[int]):
        self.group = group
        self.ranks = list(ranks)
        self.stats: Dict[str, float] = {"slots": 0, "bytes": 0, "seconds": 0.0, "pack_seconds": 0.0}

    @property
    def assembler(self) -> int:
        return self.ranks[0]

    @property
    def peers(self) -> List[int]:
        return self.ranks[1:]

    def send(self, kind: int, objects: Sequence[Any]) -> None:
        """``objects[i]`` to ``peers[i]``, all in flight at once."""
        with tracing.span("ptgnn.handoff.send") as call:
            works, held, sent, packing = [], [], 0, 0.0
            for dst, obj in zip(self.peers, objects):
                with tracing.span("ptgnn.handoff.pack") as packed:
                    head_bytes, num_buffers, blob = pack(obj)
                packing += packed.seconds
                header = torch.tensor([kind, blob.size, head_bytes, num_buffers], dtype=torch.int64)
                data = torch.from_numpy(blob)
                works += [dist.isend(header, dst, group=self.group), dist.isend(data, dst, group=self.group)]
                held.append((header, data))
                sent += blob.size
            for work in works:
                work.wait()
        if kind == SLOT:
            self._count(len(held), sent, call.seconds, packing)

    def receive(self) -> Tuple[int, Any]:
        """(kind, object) of the assembler's next message to this rank."""
        with tracing.span("ptgnn.handoff.receive") as call:
            header = torch.empty(4, dtype=torch.int64)
            dist.recv(header, self.assembler, group=self.group)
            kind, size, head_bytes, num_buffers = header.tolist()
            data = torch.empty(size, dtype=torch.uint8)
            dist.recv(data, self.assembler, group=self.group)
            with tracing.span("ptgnn.handoff.unpack") as unpacked:
                obj = unpack(data.numpy(), head_bytes, num_buffers)
        if kind == SLOT:
            self._count(1, size, call.seconds, unpacked.seconds)
        return kind, obj

    def _count(self, slots: int, size: int, seconds: float, packing: float) -> None:
        self.stats["slots"] += slots
        self.stats["bytes"] += size
        self.stats["seconds"] += seconds
        self.stats["pack_seconds"] += packing
