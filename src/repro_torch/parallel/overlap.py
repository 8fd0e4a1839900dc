"""Compute/communication overlap primitives.

``ring_all_reduce`` decomposes an all-reduce into reduce-scatter +
all-gather rings of point-to-point steps over one mesh dim's process
group. Expressed this way the 2(n-1) steps are separate operations that
a scheduler can interleave with independent compute (e.g. the next
microbatch's backward), which a single monolithic all-reduce cannot:
the classic Megatron/MaxText overlap trick, and a §Perf knob.

Each rank calls it with its own tensor, as the JAX package's runs under
``jax.shard_map`` over the axis being reduced.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def ring_all_reduce(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """All-reduce over the mesh dim ``axis_name`` as RS + AG rings.

    x: this rank's tensor, whose leading dim is divisible by the dim's
    size. Returns the summed tensor (same shape), like ``dist.all_reduce``
    over that dim's group; ``x`` is left as it was. Each step sends one
    chunk to the next rank of the ring and receives one from the
    previous (``batch_isend_irecv``).
    """
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    if n == 1:
        return x
    i = mesh.get_local_rank(axis_name)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
    chunks = x.reshape((n, -1) + tuple(x.shape[1:])).clone()
    recv = torch.empty_like(chunks[0])

    def shift(send: torch.Tensor) -> torch.Tensor:
        ops = [dist.P2POp(dist.isend, send.contiguous(), nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    # --- reduce-scatter: at step s, rank i forwards partial chunk
    # (i - s) mod n and folds the incoming partial into (i - s - 1) mod n.
    # After n-1 steps rank i owns the fully-reduced chunk (i+1) mod n.
    for s in range(n - 1):
        chunks[(i - s - 1) % n] += shift(chunks[(i - s) % n])

    # --- all-gather: rotate the reduced chunks around the ring.
    for s in range(n - 1):
        chunks[(i - s) % n] = shift(chunks[(i + 1 - s) % n])
    return chunks.reshape(x.shape)


def psum_overlapped(x: torch.Tensor, mesh, axis_name: str, use_ring: bool) -> torch.Tensor:
    """The sum of ``x`` over the mesh dim ``axis_name``: the ring, or one
    ``dist.all_reduce`` (on a copy; ``x`` is left as it was)."""
    if use_ring:
        return ring_all_reduce(x, mesh, axis_name)
    out = x.clone()
    dist.all_reduce(out, group=mesh.get_group(axis_name))
    return out
