"""Checkpoints: atomic, asynchronous, on one device (counterpart of
``repro.ckpt.checkpoint``, with its on-disk format, so either package
restores the other's checkpoints).

  atomic   : a save writes ``<dir>/tmp.<step>.<pid>`` and finishes with one
             os.replace to ``<dir>/step_<step:010d>``, so a crashed save
             never replaces a good checkpoint.
  async    : ``Checkpointer.save`` copies every leaf to the host on the
             calling thread (a snapshot of the moment of the save, which a
             later in-place update cannot reach) and a background thread
             serialises it; the next save or ``wait()`` joins it (a one-deep
             pipeline).
  placement: ``restore_params`` puts each leaf on the device of its
             counterpart in ``like``, or on ``device``; a numpy leaf of
             ``like`` (the semi-async record store's host keys) comes back
             as a numpy array of its dtype. The reference's
             ``shardings`` re-lays leaves onto a new mesh; one card has no
             mesh, so a device is all there is to choose.

Format: ``arrays.npz`` holds the leaves under their tree paths, and
``meta.json`` holds ``step``, ``dtypes``, ``metadata``, ``checksum`` and
``time``. A leaf's key is its path (``utils.tree.path_leaves``): dict
keys and sequence indices bare and NamedTuple fields as ``.field``,
joined with '/', as jax's tree paths print (GAS's bundle gives
``state/.h_buffer/h`` and ``state/.label_buffer/tokens``). bfloat16
leaves are stored as their uint16 bits under the dtype ``"bfloat16"``;
every other dtype under numpy's name. ``checksum`` is a CRC-32 over the
stored arrays in sorted key order, key names and shapes included;
``verify_checkpoint`` recomputes it, ``latest_good_step`` walks the steps
newest first to the latest that verifies, and a restore with step=None
resolves through it. An explicitly requested step that fails raises
``CorruptCheckpointError``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import tree

Params = Any

_BF16 = "bfloat16"


class CorruptCheckpointError(RuntimeError):
    """An explicitly requested checkpoint failed its content checksum."""


def _content_checksum(store: Dict[str, np.ndarray]) -> int:
    """CRC-32 over the stored (post-bitcast) arrays in sorted key order,
    key names and shapes included, so a renamed or reshaped leaf is as
    detectable as flipped payload bytes."""
    crc = 0
    for k in sorted(store):
        a = np.ascontiguousarray(store[k])
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(repr((a.shape, str(a.dtype))).encode(), crc)
        crc = zlib.crc32(memoryview(a), crc)
    return crc


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory as stored: (array, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).to("cpu", copy=True).contiguous()
            return bits.numpy().view(np.uint16), _BF16
        a = t.to("cpu", copy=True).contiguous().numpy()
    else:
        a = np.array(leaf, copy=True)
        if a.dtype.name == _BF16:            # ml_dtypes.bfloat16 arrays
            return a.view(np.uint16), _BF16
    return a, str(a.dtype)


def _host_store(params) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    store, dtypes = {}, {}
    for k, leaf in tree.path_leaves(params):
        store[k], dtypes[k] = _to_host(leaf)
    return store, dtypes


def _write(ckpt_dir: str, step: int, store: Dict[str, np.ndarray],
           dtypes: Dict[str, str], metadata: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **store)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "dtypes": dtypes,
                   "metadata": metadata or {},
                   "checksum": _content_checksum(store),
                   "time": time.time()}, f)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_params(ckpt_dir: str, step: int, params: Params,
                metadata: Optional[dict] = None) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays).
    Returns the final path."""
    store, dtypes = _host_store(params)
    return _write(ckpt_dir, step, store, dtypes, metadata)


def _steps(ckpt_dir: str) -> List[int]:
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def verify_checkpoint(ckpt_dir: str, step: int) -> bool:
    """True iff step's checkpoint is readable and its stored bytes match
    the checksum recorded at save time. A checkpoint without a checksum
    verifies when readable: os.replace already guarantees it is
    complete."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            store = {k: data[k] for k in data.files}
        if "checksum" not in meta:
            return True
        return _content_checksum(store) == int(meta["checksum"])
    except (OSError, ValueError, KeyError, zlib.error,
            zipfile.BadZipFile):
        return False


def latest_good_step(ckpt_dir: str) -> Optional[int]:
    """Newest step whose checkpoint verifies: the walk a resume takes past
    a corrupted latest checkpoint to the last good chunk boundary."""
    if not os.path.isdir(ckpt_dir):
        return None
    for s in sorted(_steps(ckpt_dir), reverse=True):
        if verify_checkpoint(ckpt_dir, s):
            return s
    return None


def _resolve_step(ckpt_dir: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_good_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no intact checkpoints under "
                                    f"{ckpt_dir}")
    return step


def read_meta(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """A checkpoint's meta.json (step, metadata, dtypes) without reading
    the arrays, so a caller can choose the restore template (params alone
    or the engine's {'params','state'} bundle) first. step=None resolves
    to the latest checkpoint that verifies."""
    step = _resolve_step(ckpt_dir, step)
    with open(os.path.join(ckpt_dir, f"step_{step:010d}", "meta.json")) as f:
        return json.load(f)


def _from_stored(arr: np.ndarray, dtype: str, proto, device):
    if isinstance(proto, np.ndarray):       # a host leaf stays on the host
        return np.array(arr, dtype=proto.dtype)
    t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
         if dtype == _BF16 else torch.from_numpy(arr))
    if (isinstance(proto, torch.Tensor) and proto.dtype != t.dtype
            and not t.is_floating_point() and not proto.is_floating_point()
            and torch.bool not in (t.dtype, proto.dtype)):
        # integer leaves take the template's width: the reference's token
        # buffers are int32 where the port's device batches are int64
        t = t.to(proto.dtype)
    return t.to(device)


def restore_params(ckpt_dir: str, like: Params, step: Optional[int] = None,
                   device=None) -> Tuple[Params, dict]:
    """Restore into the structure of ``like``: each leaf as a tensor on
    ``device`` when given, else on the device of its counterpart in
    ``like`` (the CPU for a leaf that is not a tensor); a numpy leaf of
    ``like`` as a numpy array of its dtype."""
    step = _resolve_step(ckpt_dir, step)
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            data = {k: npz[k] for k in npz.files}
    except FileNotFoundError:
        raise
    except (OSError, ValueError, zlib.error, zipfile.BadZipFile) as e:
        raise CorruptCheckpointError(
            f"checkpoint step {step} under {ckpt_dir} is unreadable "
            f"({e}). Restore with step=None to fall back to the latest "
            f"good checkpoint.") from e
    if "checksum" in meta and \
            _content_checksum(data) != int(meta["checksum"]):
        raise CorruptCheckpointError(
            f"checkpoint step {step} under {ckpt_dir} fails its content "
            f"checksum: bytes on disk do not match what was saved. "
            f"Restore with step=None to fall back to the latest good "
            f"checkpoint.")
    out = []
    for k, proto in tree.path_leaves(like):
        arr = data[k]
        assert arr.shape == tuple(proto.shape), (
            f"{k}: ckpt shape {arr.shape} != model shape {proto.shape}")
        dev = device if device is not None else (
            proto.device if isinstance(proto, torch.Tensor) else "cpu")
        out.append(_from_stored(arr, meta["dtypes"][k], proto, dev))
    return tree.replace_leaves(like, out), meta


class Checkpointer:
    """Async, keep-last-k checkpoint manager."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, params: Params,
             metadata: Optional[dict] = None, block: bool = False) -> None:
        self.wait()                       # one-deep pipeline
        # the host copy is taken here, before the worker starts: the worker
        # never reads a device tensor, and the snapshot is of this moment
        store, dtypes = _host_store(params)

        def work():
            try:
                _write(self.dir, step, store, dtypes, metadata)
                self._gc()
            except Exception as e:        # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in sorted(_steps(self.dir))[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def restore(self, like: Params, step: Optional[int] = None,
                device=None):
        self.wait()
        return restore_params(self.dir, like, step, device)
