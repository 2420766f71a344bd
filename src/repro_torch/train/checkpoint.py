"""Fault-tolerant checkpointing: atomic, async, self-validating (the JAX
package's ``train/checkpoint.py``, same layout).

Layout (one directory per step):

    <dir>/step_000120.tmp-<nonce>/   # written here first
        arrays.npz                   # leaves as host numpy arrays
        meta.json                    # step, keys, CRC32 per leaf, shapes, dtypes
    <dir>/step_000120/               # atomic rename after fsync

Leaves are named by their path in the tree, the keys (or list indices)
joined by "/", as the reference names them, so a checkpoint of the same
tree written by either package restores in the other.  A bf16 leaf keeps
its bits: it is written as ``uint16`` with ``bfloat16`` recorded in
``dtypes`` (numpy has no bf16), and restored through a view.

  * **atomic**   — a crash mid-save never corrupts the latest checkpoint
    (tmp dir + rename; restore scans only completed dirs).
  * **async**    — ``save_async`` copies the tensors to the host, then
    writes on a background thread (one save in flight); training continues.
  * **elastic**  — leaves are stored whole: a ``DTensor`` leaf (a state
    split over a mesh) is gathered leaf by leaf, every rank taking part,
    and rank 0 alone writes; ``restore(..., shardings=)`` cuts each rank's
    block for any mesh, another than the saver's included.
  * **self-validating** — per-leaf CRCs catch torn/corrupt files.
  * **GC**       — keeps the most recent ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.data import resolve_device
from ..tree import flatten_with_paths, tree_map, unflatten_like

BF16 = "bfloat16"
_CHUNK = 1 << 28  # bytes a write


def _to_host(x):
    """A leaf as a host numpy array (bf16 as its uint16 bits): a snapshot,
    also of a host tensor.  A card's tensor is copied into pinned memory
    without blocking (several times pageable memory's rate); ``save``
    synchronizes once after the last leaf."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.is_cuda:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            x = h
        else:
            x = x.clone()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _whole(x):
    """A ``DTensor`` leaf gathered whole (a collective); anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved_step: Optional[int] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Any, block: bool = True) -> None:
        """Every rank calls it where ``state`` holds ``DTensor``s; rank 0
        writes."""
        dtypes = {k: BF16 for k, v in flatten_with_paths(state).items()
                  if torch.is_tensor(v) and v.dtype == torch.bfloat16}
        if not block:
            self.wait()  # one in-flight save at a time
        # copied off the device before any thread starts, leaf by leaf (a
        # split leaf gathered whole only while it is copied); the writer owns
        # the only reference, and drops each leaf once it is in the file
        rank0 = _rank() == 0

        def leaf(x):
            x = _whole(x)
            return _to_host(x) if rank0 else None

        host = flatten_with_paths(tree_map(leaf, state))
        if any(torch.is_tensor(v) and v.is_cuda for v in flatten_with_paths(state).values()):
            torch.cuda.synchronize()  # the pinned copies have landed
        if not rank0:
            return
        structure = _structure(state)
        if block:
            self._write(step, host, dtypes, structure)
        else:
            self._thread = threading.Thread(target=self._write, args=(step, host, dtypes, structure), daemon=True)
            self._thread.start()
            del host

    def save_async(self, step: int, state: Any) -> None:
        self.save(step, state, block=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays: Dict[str, np.ndarray], bf16: Dict[str, str], structure: str) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp-{os.getpid()}-{time.time_ns()}"
        tmp.mkdir(parents=True)
        try:
            meta = {"step": step, "treedef": structure, "keys": sorted(arrays), "crc": {}, "shapes": {},
                    "dtypes": {}}
            # the leaves' CRCs on a few threads (zlib releases the GIL) while
            # the leaves are written, in np.savez's layout (one .npy a leaf
            # in a zip), leaf by leaf, each host copy freed once it is in
            # the file
            keys = list(arrays)
            with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool, \
                    zipfile.ZipFile(tmp / "arrays.npz", "w", allowZip64=True) as zf:
                crcs = {k: pool.submit(_crc, arrays[k]) for k in keys}
                for k in keys:
                    v = np.require(arrays[k], requirements="C")  # keeps a 0-d leaf 0-d
                    meta["shapes"][k] = list(v.shape)
                    meta["dtypes"][k] = bf16.get(k, str(v.dtype))
                    with zf.open(k + ".npy", "w", force_zip64=True) as f:
                        np.lib.format.write_array_header_1_0(f, np.lib.format.header_data_from_array_1_0(v))
                        flat = v.reshape(-1).view(np.uint8)
                        for i in range(0, flat.size, _CHUNK):
                            f.write(flat[i:i + _CHUNK])
                    meta["crc"][k] = crcs.pop(k).result()
                    del arrays[k], v, flat
            meta["time"] = time.time()
            with open(tmp / "meta.json", "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self.last_saved_step = step
            self._gc()
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and ".tmp" not in p.name:
                if (p / "meta.json").exists():
                    out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None, device=None,
                validate: bool = True, shardings: Optional[Any] = None) -> Tuple[Any, int]:
        """Restore into the structure, shapes and dtypes of ``target`` (a
        tree of tensors, meta-device ones included), on ``device`` (CUDA
        unless the caller names another).  ``shardings``: a tree of
        ``launch.sharding.NamedSharding``s over ``target``'s structure; each
        leaf is then this rank's block, placed as a ``DTensor`` (elastic: the
        mesh need not be the saver's)."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "meta.json").read_text())
        arrays = np.load(d / "arrays.npz")
        if validate:
            for k, crc in meta["crc"].items():
                if _crc(arrays[k]) != crc:
                    raise IOError(f"checkpoint {d} leaf {k}: CRC mismatch")
        flat_s = flatten_with_paths(shardings) if shardings is not None else {}
        out = {}
        for k, tgt in flatten_with_paths(target).items():
            if k not in arrays:
                raise KeyError(f"checkpoint missing leaf {k}")
            v = arrays[k]
            if tuple(v.shape) != tuple(tgt.shape):
                raise ValueError(f"{k}: shape {v.shape} != target {tuple(tgt.shape)}")
            if meta["dtypes"].get(k) == BF16:
                t = torch.from_numpy(np.array(v).view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(v))
            if k in flat_s:
                from ..launch import sharding as sh

                out[k] = sh.place(sh.shard(t, flat_s[k]).to(device=dev, dtype=tgt.dtype, copy=True), flat_s[k],
                                  tuple(tgt.shape))
            else:
                out[k] = t.to(device=dev, dtype=tgt.dtype)
        return unflatten_like(target, out), step


def _structure(tree) -> str:
    """The tree's shape of containers, for the record (the reference writes
    its treedef's string)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(v)}" for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"
