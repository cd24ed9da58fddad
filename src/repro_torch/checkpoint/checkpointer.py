"""Asynchronous, atomic, integrity-checked checkpointing (port of
``repro.checkpoint.checkpointer``), in the reference's on-disk layout::

    <dir>/step_00000200.tmp/...    written first, renamed on completion
    <dir>/step_00000200/
        proc_00000.npz             the arrays, keyed by their tree path
        META                       msgpack: step, keys, dtypes, crc32s, nprocs

so either package restores the other's checkpoints.

* async: ``save`` copies every leaf to host memory at once (training may
  then overwrite its tensors in place), and a background thread writes;
* atomic: readers never see a partial step (``.tmp`` then rename);
* integrity: a crc32 per stored array, checked on restore;
* keep-k: older steps are removed after a successful save.

npz stores no bfloat16 or fp8: those leaves are stored as their integer
bit-views (uint16, uint8) with the dtype's name in META, and read back with
``Tensor.view(dtype)``.  META goes through the port's own msgpack codec
(``checkpoint.codec``).  Restore places the leaves on ``device`` (default:
each template leaf's own), or with ``shardings=`` under each leaf's
sharding on the current mesh, whatever mesh saved it (elastic restart).

In a job of several ranks (``torch.distributed``), ``save`` gathers each
DTensor leaf to a whole tensor (a collective: every rank calls ``save``)
and rank 0 alone writes, in the same one-process layout.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import codec
from repro_torch.distributed.sharding import gather, mesh_device, place

PyTree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")

# the dtypes npz cannot hold: their torch dtype, the torch integer view
# that reads their bits, and the numpy dtype stored in the npz
_EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_EXT_NAMES = {torch_dtype: name for name, (torch_dtype, _, _) in _EXT_DTYPES.items()}
_NUMPY_BITS = {torch.int16: np.int16, torch.uint8: np.uint8}


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (a tensor or an array) as a numpy array npz can
    store, and the dtype name META records."""
    if isinstance(leaf, torch.Tensor):
        t = gather(leaf.detach()).to("cpu", copy=True)
        name = _EXT_NAMES.get(t.dtype)
        if name is not None:
            _, bits, stored = _EXT_DTYPES[name]
            return t.view(bits).numpy().view(stored), name
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(leaf, copy=True)
    if a.dtype.name in _EXT_DTYPES:  # an ml_dtypes array
        return a.view(_EXT_DTYPES[a.dtype.name][2]), a.dtype.name
    return a, a.dtype.name


def _from_host(a: np.ndarray, name: str) -> torch.Tensor:
    if name in _EXT_DTYPES:
        torch_dtype, bits, _ = _EXT_DTYPES[name]
        return torch.from_numpy(a.view(_NUMPY_BITS[bits])).view(torch_dtype)
    return torch.from_numpy(a)


def _crc32(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _flatten_with_paths(tree: PyTree) -> dict[str, Any]:
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            flat["/".join(path)] = node

    walk(tree, ())
    return flat


def _unflatten_like(template: PyTree, flat: dict[str, Any]) -> PyTree:
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], path + (str(k),)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        return flat["/".join(path)]

    return walk(template, ())


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: list[BaseException] = []

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: PyTree, blocking: bool = False):
        """Copy to host memory now, write to disk on a background thread
        (rank 0's, in a job of several ranks)."""
        host = {k: _to_host(v) for k, v in _flatten_with_paths(tree).items()}
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        self.wait()  # one outstanding save at a time
        self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, host: dict[str, tuple[np.ndarray, str]]):
        try:
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            encoded = {k: a for k, (a, _) in host.items()}
            np.savez(os.path.join(tmp, "proc_00000.npz"), **encoded)
            meta = {
                "step": step,
                "keys": list(host),
                "dtypes": {k: name for k, (_, name) in host.items()},
                "crc32": {k: _crc32(a) for k, a in encoded.items()},
                "nprocs": 1,
            }
            with open(os.path.join(tmp, "META"), "wb") as f:
                f.write(codec.packb(meta))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        except BaseException as e:  # noqa: BLE001 - raised again by wait()
            self._error.append(e)

    def join(self):
        """Wait for an outstanding save to finish, leaving its error (if any)
        for :meth:`wait`."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self):
        """Wait for an outstanding save; raise the error of a failed one."""
        self.join()
        if self._error:
            raise self._error.pop()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

    # ---------------------------------------------------------- restore --
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, step: int | None = None, shardings: PyTree | None = None,
                device: str | torch.device | None = None) -> PyTree:
        """Load a checkpoint into the structure of ``template`` as tensors on
        ``device`` (default: each template leaf's device, the CPU for a
        leaf that is not a tensor).  ``shardings`` (the same structure, of
        ``distributed.sharding.NamedSharding``) places each leaf it names
        as a DTensor under that sharding on its mesh, on the mesh's device;
        the mesh the checkpoint was saved from does not matter."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "META"), "rb") as f:
            meta = codec.unpackb(f.read())
        with np.load(os.path.join(path, "proc_00000.npz")) as z:
            host = {k: z[k] for k in z.files}
        for k, crc in meta["crc32"].items():
            if _crc32(host[k]) != crc:
                raise IOError(f"checkpoint corruption in {k} @ step {step}")
        dtypes = meta.get("dtypes", {})
        flat_template = _flatten_with_paths(template)
        flat_shardings = _flatten_with_paths(shardings) if shardings is not None else {}
        placed = {}
        for k, a in host.items():
            t = _from_host(a, dtypes.get(k, a.dtype.name))
            sh = flat_shardings.get(k)
            if sh is not None:
                placed[k] = place(t.to(mesh_device(sh.mesh)), sh)
                continue
            like = flat_template.get(k)
            dev = device if device is not None else (
                like.device if isinstance(like, torch.Tensor) else "cpu")
            placed[k] = t.to(dev)
        return _unflatten_like(template, placed)
