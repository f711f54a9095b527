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


def restore_checkpoint(path, target_tree) -> Tuple[Any, int]:
    """Restore into the structure of ``target_tree``: each leaf in its
    target's dtype and on its device. Raises on a shape mismatch or a leaf
    the checkpoint lacks."""
    path = Path(path)
    with open(path / "manifest.json") as f:
        manifest = json.load(f)

    flat_target = _flatten(target_tree)
    loaded = {}
    for key, meta in manifest["leaves"].items():
        if key not in flat_target:
            continue
        t = _from_bytes((path / meta["file"]).read_bytes(), meta["dtype"], meta["shape"])
        tgt = flat_target[key]
        if t.shape != tgt.shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"ckpt {tuple(t.shape)} vs target {tuple(tgt.shape)}")
        loaded[key] = t.to(device=tgt.device, dtype=tgt.dtype)

    missing = set(flat_target) - set(loaded)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}...")
    return _rebuild(target_tree, loaded), manifest["step"]


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
