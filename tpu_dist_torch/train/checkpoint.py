"""Checkpoint and resume: the JAX package's single-writer ``.npz`` format.

One ``.npz`` per checkpoint holds the leaves of a tree (nested dicts, lists
and tuples) as ``leaf_0``, ``leaf_1``, ... and a JSON ``__meta__`` with the
stored ``step``, the leaves' key ``paths`` and a sha256 ``digest``.  The
tree is flattened as ``jax.tree_util.tree_flatten_with_path`` flattens it
(dict keys sorted, list and tuple positions in order, ``None`` and empty
containers giving no leaf) and each path is written as
``jax.tree_util.keystr`` writes it (``['params'][0]['w']``), so a file
written here restores in `tpu_dist.train.checkpoint` and the reverse.  The
trainers hand over their state in the JAX package's layout, as views of
their live tensors (`interop.jax_views`).

Only rank 0 writes: data-parallel replicas are identical.  The write goes
to ``<name>.tmp.npz`` and is renamed into place, so a reader never sees a
half-written file under the final name; `latest_intact` skips any file
whose digest does not match its bytes.

The sharded directory format (``save_sharded``), orbax and the chaos
truncation come with resilience (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def _children(node) -> list | None:
    """``(key, child)`` pairs in JAX's flatten order, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """``[(keystr path, leaf), ...]`` in JAX's leaf order."""
    out = []

    def walk(node, path):
        children = _children(node)
        if children is None:
            out.append((path, node))
            return
        for key, child in children:
            walk(child, path + f"[{key!r}]")

    walk(tree, "")
    return out


def unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` whose leaves are ``leaves``, taken in
    JAX's leaf order."""
    it = iter(leaves)

    def build(node):
        children = _children(node)
        if children is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in children}
        if node is None:
            return None
        return type(node)(build(v) for _, v in children)

    return build(like)


def _host(leaf) -> np.ndarray:
    """A leaf as a C-ordered numpy array: a tensor (or a view of one) is
    copied off its device, or on the CPU cloned, so later in-place updates
    of the tensor do not reach the array; an array is taken as it is."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", memory_format=torch.contiguous_format, copy=True).numpy()
    return np.asarray(leaf)


def _tree_digest(paths: list[str], arrays: list[np.ndarray]) -> str:
    """sha256 over key paths, shapes and raw leaf bytes, in leaf order (the
    JAX package's digest, dtype-blind as there)."""
    h = hashlib.sha256()
    for k, a in zip(paths, arrays, strict=True):
        a = np.asarray(a)
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _writes() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _write(path: Path, leaves: list[tuple[str, np.ndarray]], step: int) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"leaf_{i}": a for i, (_, a) in enumerate(leaves)}
    paths = [k for k, _ in leaves]
    meta = {"step": step, "paths": paths, "digest": _tree_digest(paths, list(arrays.values()))}
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, __meta__=json.dumps(meta), **arrays)
    tmp.rename(path)


def save(path: str | Path, tree: Any, *, step: int = 0) -> None:
    """Write ``tree`` (leaves: tensors or arrays) to ``path`` with
    ``step``; a no-op on every rank but 0."""
    if not _writes():
        return
    _write(Path(path), [(k, _host(x)) for k, x in flatten_with_paths(tree)], step)


class AsyncCheckpointer:
    """Checkpoint writes that overlap training.

    ``save`` copies every leaf to host memory before it returns, so the
    next step may update the tensors in place; the file is written on a
    background thread.  The next ``save`` or ``wait`` joins the write in
    flight first (one at a time, files complete in submission order), and
    ``wait`` re-raises the writer's error.  Use it as a context manager,
    or call ``wait`` before reading the file or exiting."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None
        # of the last save: the device-to-host copy, and the file write
        self.snapshot_seconds = self.write_seconds = 0.0

    def save(self, path: str | Path, tree: Any, *, step: int = 0) -> None:
        """As `save`: the leaves are copied to host memory now, the file is
        written on the background thread."""
        self.wait()
        if not _writes():
            return
        t0 = time.perf_counter()
        leaves = [(k, _host(x)) for k, x in flatten_with_paths(tree)]
        self.snapshot_seconds = time.perf_counter() - t0

        def write():
            t1 = time.perf_counter()
            try:
                _write(Path(path), leaves, step)
            except BaseException as e:  # surfaced on wait()
                self._exc = e
            self.write_seconds = time.perf_counter() - t1

        self._thread = threading.Thread(target=write, name="checkpoint-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight, if any; re-raise its error here."""
        if self._thread is None:
            return
        self._thread.join()
        self._thread = None
        exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc_info) -> bool:
        self.wait()
        return False


def _load(path: Path) -> tuple[dict, list[np.ndarray]]:
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        leaves = [data[f"leaf_{i}"] for i in range(len(meta["paths"]))]
    return meta, leaves


def restore(path: str | Path, like: Any) -> tuple[Any, int]:
    """The tree stored at ``path``, shaped like the template ``like``, as
    numpy arrays, and its step.  Raises when the stored paths are not
    ``like``'s or the digest does not match the bytes."""
    meta, leaves = _load(Path(path))
    want = [k for k, _ in flatten_with_paths(like)]
    if want != meta["paths"]:
        raise ValueError(
            f"checkpoint {path} structure mismatch: "
            f"{meta['paths'][:3]}... vs {want[:3]}..."
        )
    digest = meta.get("digest")
    if digest is not None and _tree_digest(meta["paths"], leaves) != digest:
        raise ValueError(
            f"checkpoint {path} failed checksum validation (truncated or corrupt); "
            "use latest_intact() to find the newest valid snapshot"
        )
    return unflatten(like, leaves), meta["step"]


def _inspect(path: Path) -> int | None:
    """The stored step when ``path`` is a readable checkpoint whose digest
    matches its bytes, else None (never raises)."""
    try:
        meta, leaves = _load(path)
        digest = meta.get("digest")
        if digest is not None and _tree_digest(meta["paths"], leaves) != digest:
            return None
        return int(meta["step"])
    except Exception:
        return None


def verify(path: str | Path) -> bool:
    """True when ``path`` is a readable, internally consistent checkpoint."""
    return _inspect(Path(path)) is not None


def latest_intact(directory: str | Path, pattern: str = "*ckpt_*") -> Path | None:
    """The newest valid checkpoint under ``directory`` (by stored step,
    then modification time), skipping in-flight ``.tmp`` files and any
    file that fails `verify`; None when there is none."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    best = None
    for cand in directory.glob(pattern):
        if cand.name.endswith((".tmp", ".tmp.npz")):
            continue
        step = _inspect(cand)
        if step is None:
            continue
        try:
            key = (step, cand.stat().st_mtime)
        except OSError:
            continue
        if best is None or key > best[0]:
            best = (key, cand)
    return best[1] if best is not None else None
