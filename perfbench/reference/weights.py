"""Weights of a configuration, made on the device from (seed, block name).

A block is one layer (``layers.3``, ``dense_layers.0``) or one top-level
tensor group (``embed``, ``lm_head``, ``shared_attn``, ...). Its normally
distributed tensors, in name order, are one ``normal_`` call on one flat
buffer from a generator seeded by (seed, block); its other tensors follow
from the same generator. So any block can be made again, alone and exactly,
from the seed: the benchmark fills the program's parameters with them, and
the reference makes them again one block at a time instead of holding a
second copy. The parameter names and shapes are the family's
``param_spec``; nothing here reads the program.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, Tuple

import torch

INIT_STD = 0.02
STACKS = ("layers", "dense_layers", "enc_layers")

Spec = Dict[str, Tuple[Tuple[int, ...], str]]  # name -> (shape, init)


def block_of(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] in STACKS else parts[0]


def block_seed(seed: int, block: str) -> int:
    digest = hashlib.sha256(f"{seed}/{block}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def blocks(spec: Spec) -> Dict[str, list]:
    """Block name -> its tensor names, sorted, blocks in spec order."""
    out: Dict[str, list] = {}
    for name in spec:
        out.setdefault(block_of(name), []).append(name)
    return {b: sorted(names) for b, names in out.items()}


def _numel(shape) -> int:
    return math.prod(shape)


def make_block(spec: Spec, names, seed: int, block: str, device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The tensors of one block in ``dtype`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, block))
    normal = [n for n in names if spec[n][1] == "normal"]
    flat = torch.empty(sum(_numel(spec[n][0]) for n in normal), dtype=dtype, device=device)
    flat.normal_(0.0, INIT_STD, generator=gen)
    out, offset = {}, 0
    for n in normal:
        size = _numel(spec[n][0])
        out[n] = flat[offset:offset + size].view(spec[n][0])
        offset += size
    for n in names:
        shape, init = spec[n]
        if init == "normal":
            continue
        if init == "ones":
            out[n] = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            out[n] = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "a_log":  # Mamba-2: A uniform in [1, 16]
            a = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
                1.0, 16.0, generator=gen)
            out[n] = torch.log(a).to(dtype)
        elif init == "dt_bias":  # Mamba-2: softplus(dt_bias) log-uniform in [1e-3, 1e-1]
            u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
                generator=gen)
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
            dt = torch.clamp(dt, min=1e-4)
            out[n] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        else:
            raise ValueError(f"unknown init {init!r} for {n}")
    return out


def iter_blocks(spec: Spec, seed: int, device, dtype) -> Iterator[Dict[str, torch.Tensor]]:
    for block, names in blocks(spec).items():
        yield make_block(spec, names, seed, block, device, dtype)


class Weights:
    """The reference's view of the weights: ``get(name)`` in float32, made
    again from the seed one block at a time (the last block is kept)."""

    def __init__(self, spec: Spec, seed: int, device, dtype: torch.dtype):
        self.spec, self.seed, self.device, self.dtype = spec, seed, device, dtype
        self._names = blocks(spec)
        self._block, self._tensors = None, {}

    def get(self, name: str) -> torch.Tensor:
        block = block_of(name)
        if block != self._block:
            self._tensors = {}  # drop the last block before making the next
            made = make_block(self.spec, self._names[block], self.seed, block,
                              self.device, self.dtype)
            self._tensors = {k: v.float() for k, v in made.items()}
            self._block = block
        return self._tensors[name]
