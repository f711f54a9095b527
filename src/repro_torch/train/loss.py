"""Next-token cross entropy, optionally chunked over the sequence so that the
(B, S, V) logits are never all held at once (per chunk: (chunk, V)); the
counterpart of ``repro.train.loss``."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed import constrain
from repro_torch.models.layers import DATA, MODEL, gather_sequence

NEG_INF = -1e30


def _ce(logits: torch.Tensor, labels: torch.Tensor,
        vocab: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed CE and correct-token count for (N, V) logits / (N,) labels.
    Padding columns (>= ``vocab``) are masked with ``torch.where``, so that
    no tensor autograd saves is written in place."""
    logits = logits.float()
    if vocab and logits.shape[-1] != vocab:  # mask vocabulary padding
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(cols[None, :] < vocab, logits,
                             torch.tensor(NEG_INF, device=logits.device))
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    # (N, 1) kept whole: on a vocabulary-sharded DTensor the gather is a
    # masked partial sum whose mask has this shape.
    picked = torch.gather(logits, 1, labels[:, None].long())
    loss_sum = torch.sum(lse - picked)
    acc = torch.sum(_argmax_rows(logits.detach()) == labels)
    return loss_sum, acc


def _argmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """``argmax(logits, -1)`` of (N, V) logits, the first index among equal
    maxima (as ``jnp.argmax``). A DTensor whose V is sharded is not
    gathered: each rank takes its shard's max and first argmax (plus the
    shard's offset), the max is all-reduced over the sharding mesh dims,
    and then the smallest index holding it, two all-reduces of (N,), as
    XLA partitions an argmax. DTensor's own argmax over a sharded dim reads
    a value on the host, which a trace under fake tensors cannot."""
    from repro_torch.distributed.sharding import is_distributed

    if not is_distributed(logits):
        return torch.argmax(logits, dim=-1)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, pl = logits.device_mesh, tuple(logits.placements)
    vocab_dims = [i for i, p in enumerate(pl) if p.is_shard() and p.dim % 2 == 1]
    if not vocab_dims:
        return torch.argmax(logits, dim=-1)
    local = logits.to_local()
    coordinate = mesh.get_coordinate()
    shard, offset = local.shape[1], 0
    for i in vocab_dims:  # major to minor, in mesh order
        offset = offset * mesh.size(i) + coordinate[i]
    offset *= shard
    rows = (logits.shape[0],)

    def reduced(t, op):
        part = tuple(Partial(op) if i in vocab_dims else p for i, p in enumerate(pl))
        whole = tuple(Replicate() if i in vocab_dims else p for i, p in enumerate(pl))
        return DTensor.from_local(t, mesh, part, run_check=False, shape=rows,
                                  stride=(1,)).redistribute(mesh, whole)

    local_max = torch.amax(local, dim=-1)
    first = torch.where(local_max == reduced(local_max, "max").to_local(),
                        torch.argmax(local, dim=-1) + offset, logits.shape[1])
    return reduced(first, "min")


def cross_entropy_loss(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                       chunk: int = 0, vocab: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE and accuracy (f32 scalars) of hidden (B,S,d) under
    head (d,V) against labels (B,S), in f32 logits. ``chunk`` > 0 takes the
    rows in chunks of that many (when it divides B*S and is smaller);
    ``vocab`` is the true vocabulary when the head is padded."""
    b, s, d = hidden.shape
    n = b * s
    h2 = gather_sequence(hidden).reshape(n, d)
    l2 = labels.reshape(n)
    head32 = head.float()
    if chunk <= 0 or n % chunk != 0 or n <= chunk:
        loss_sum, acc = _ce(constrain(h2.float() @ head32, DATA, MODEL), l2, vocab)
        return loss_sum / n, acc / n
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    acc = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, n, chunk):
        logits = constrain(h2[i:i + chunk].float() @ head32, DATA, MODEL)
        ls, ac = _ce(logits, l2[i:i + chunk], vocab)
        loss_sum, acc = loss_sum + ls, acc + ac
    return loss_sum / n, acc / n
