"""Fault-tolerant checkpointing in the reference's on-disk layout; the
counterpart of ``repro.checkpoint.ckpt``.

  * atomic: written to ``<dir>/tmp.<step>``, the manifest fsynced, then
    renamed to ``step_<N:08d>``, so a crash mid-save never corrupts the
    latest checkpoint;
  * manifest-carrying: ``manifest.json`` records each leaf's file, shape
    and dtype (the reference's names: float32, bfloat16, int32, ...), and
    each leaf is its raw bytes, so a checkpoint written by either package
    restores into the other;
  * async: ``AsyncCheckpointer`` snapshots to host memory synchronously and
    writes on a background thread;
  * self-pruning: keeps the newest ``keep`` checkpoints.

A tree is nested dicts with tensors at the leaves; a leaf's key is its path
joined by "/", as the reference flattens a pytree. For a train state that
is ``repro_torch.train.state.state_tree``'s tree: params/layers/attn/wq,
opt/mu/..., opt/count, step.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
               torch.float64: "float64", torch.int8: "int8", torch.int16: "int16",
               torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
               torch.bool: "bool"}
DTYPES = {name: dtype for dtype, name in DTYPE_NAMES.items()}


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for key, child in sorted(tree.items()):
        flat.update(_flatten(child, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def _rebuild(tree, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    """A tree of ``tree``'s structure with the leaves of ``leaves``."""
    if not isinstance(tree, dict):
        return leaves[prefix]
    return {key: _rebuild(child, leaves, f"{prefix}/{key}" if prefix else str(key))
            for key, child in tree.items()}


def _host(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor of its own (a copy)."""
    return leaf.detach().to("cpu", copy=True).contiguous()


def _raw_bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: write its 16 bits
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_bytes(data: bytes, dtype_name: str, shape) -> torch.Tensor:
    if dtype_name not in DTYPES:
        raise ValueError(f"checkpoint dtype {dtype_name!r} is not one of {sorted(DTYPES)}")
    dtype = DTYPES[dtype_name]
    if dtype == torch.bfloat16:
        arr = np.frombuffer(data, dtype=np.int16)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).reshape(shape)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return torch.from_numpy(np.frombuffer(data, dtype=np_dtype).copy()).reshape(shape)


def save_checkpoint(directory, step: int, tree, *, keep: int = 3) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp.{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    manifest = {"step": step, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        t = leaf.detach().contiguous() if leaf.device.type == "cpu" else _host(leaf)
        fname = key.replace("/", "__") + ".bin"
        (tmp / fname).write_bytes(_raw_bytes(t))
        manifest["leaves"][key] = {"file": fname, "shape": list(t.shape),
                                   "dtype": DTYPE_NAMES[t.dtype]}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    final = directory / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)

    ckpts = sorted(directory.glob("step_*"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def latest_checkpoint(directory) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    ckpts = sorted(p for p in directory.glob("step_*")
                   if (p / "manifest.json").exists())
    return ckpts[-1] if ckpts else None


def restore_checkpoint(path, target_tree, shardings=None) -> Tuple[Any, int]:
    """Restore into the structure of ``target_tree``: each leaf in its
    target's dtype and on its device. Raises on a shape mismatch or a leaf
    the checkpoint lacks.

    ``shardings``: an optional tree of the same structure of
    :class:`~repro_torch.distributed.sharding.NamedSharding` on a
    ``DeviceMesh``; each leaf is then restored onto its placement, plain on
    the mesh's device when the mesh has one device, else as a DTensor of
    which each rank reads its own block of the leaf's file and nothing
    else. The targets may then be ``meta`` tensors (shapes and dtypes only,
    e.g. ``train.state.abstract_train_state``'s)."""
    path = Path(path)
    with open(path / "manifest.json") as f:
        manifest = json.load(f)

    flat_target = _flatten(target_tree)
    flat_shard = _flatten(shardings) if shardings is not None else {}
    loaded = {}
    for key, meta in manifest["leaves"].items():
        if key not in flat_target:
            continue
        tgt = flat_target[key]
        if tuple(meta["shape"]) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"ckpt {tuple(meta['shape'])} vs target {tuple(tgt.shape)}")
        if key in flat_shard:
            loaded[key] = _restore_sharded(path / meta["file"], meta, tgt.dtype,
                                           flat_shard[key])
        else:
            t = _from_bytes((path / meta["file"]).read_bytes(), meta["dtype"], meta["shape"])
            loaded[key] = t.to(device=tgt.device, dtype=tgt.dtype)

    missing = set(flat_target) - set(loaded)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}...")
    return _rebuild(target_tree, loaded), manifest["step"]


def _read_block(file: Path, dtype_name: str, shape, local, offset) -> torch.Tensor:
    """The block of extent ``local`` at ``offset`` of a leaf's file, read
    through a memory map, so that the rest of the file is not read."""
    if not shape:
        return _from_bytes(file.read_bytes(), dtype_name, shape)
    if dtype_name not in DTYPES:
        raise ValueError(f"checkpoint dtype {dtype_name!r} is not one of {sorted(DTYPES)}")
    dtype = DTYPES[dtype_name]
    np_dtype = np.int16 if dtype == torch.bfloat16 else torch.empty((), dtype=dtype).numpy().dtype
    whole = np.memmap(file, dtype=np_dtype, mode="r", shape=tuple(shape))
    block = torch.from_numpy(np.array(whole[tuple(slice(o, o + n)
                                                  for o, n in zip(offset, local))]))
    del whole
    return block.view(torch.bfloat16) if dtype == torch.bfloat16 else block


def _restore_sharded(file: Path, meta, dtype: torch.dtype, sharding) -> torch.Tensor:
    """A leaf on its sharding: plain on a one-device mesh's device, else a
    DTensor holding this rank's block alone."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import local_shape_and_offset, mesh_size, placements

    mesh, shape = sharding.mesh, tuple(meta["shape"])
    if mesh_size(mesh) == 1:
        t = _from_bytes(file.read_bytes(), meta["dtype"], shape)
        return t.to(device=mesh.device_type, dtype=dtype)
    local, offset = local_shape_and_offset(shape, mesh, sharding.spec, mesh.get_coordinate())
    block = _read_block(file, meta["dtype"], shape, local, offset)
    return DTensor.from_local(block.to(device=mesh.device_type, dtype=dtype), mesh,
                              placements(mesh, sharding.spec, shape), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


class AsyncCheckpointer:
    """Snapshot synchronously, persist asynchronously."""

    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save(self, step: int, tree) -> None:
        self.wait()
        host_tree = _rebuild(tree, {k: _host(v) for k, v in _flatten(tree).items()})

        def _write():
            try:
                save_checkpoint(self.directory, step, host_tree, keep=self.keep)
            except Exception as e:  # noqa: BLE001 — raised by the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
