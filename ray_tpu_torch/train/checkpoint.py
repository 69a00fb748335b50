"""Path-based checkpoints + top-k retention.

Reference: ``python/ray/train/_checkpoint.py:55`` (``Checkpoint`` = directory +
filesystem), ``train/_internal/checkpoint_manager.py`` (top-k by score),
``train/_internal/storage.py:350`` (``StorageContext`` — consistent experiment
layout across head/workers).

TPU-native note: sharded ``jax.Array`` trees are written per-host (each host
persists only its addressable shards — see ``jax_utils.save_pytree``), so a
checkpoint directory is the union of per-host writes on a shared filesystem,
exactly how multi-host orbax lays it out.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Checkpoint:
    """A directory of files; the unit of train/tune fault-tolerance.

    ``path`` may be a local directory or a pyarrow-filesystem URI
    (``file://``, ``s3://``, ...; reference: _checkpoint.py:55 — a
    Checkpoint is a directory + filesystem).  URI-backed checkpoints
    materialize to a local temp dir on access."""

    def __init__(self, path: str):
        from .storage import is_uri

        self._uri = path if is_uri(path) else None
        self.path = path if self._uri else os.path.abspath(path)
        self._local_cache: Optional[str] = None

    @property
    def uri(self) -> Optional[str]:
        return self._uri

    def _local_path(self) -> str:
        """A local directory with the checkpoint contents."""
        if self._uri is None:
            return self.path
        if self._local_cache is None:
            from pyarrow import fs as pafs

            from .storage import resolve

            src_fs, src_path = resolve(self._uri)
            dest = tempfile.mkdtemp(prefix="raytpu-ckpt-fetch-")
            pafs.copy_files(src_path, dest, source_filesystem=src_fs,
                            destination_filesystem=pafs.LocalFileSystem())
            self._local_cache = dest
        return self._local_cache

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        return cls(uri)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="raytpu-ckpt-")
        with open(os.path.join(d, "_dict_checkpoint.json"), "w") as f:
            json.dump(data, f, default=repr)
        import pickle
        with open(os.path.join(d, "_dict_checkpoint.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> Dict[str, Any]:
        import pickle
        with open(os.path.join(self._local_path(),
                               "_dict_checkpoint.pkl"), "rb") as f:
            return pickle.load(f)

    def to_directory(self, path: Optional[str] = None) -> str:
        local = self._local_path()
        if path is None or os.path.abspath(path) == local:
            return local
        os.makedirs(path, exist_ok=True)
        shutil.copytree(local, path, dirs_exist_ok=True)
        return path

    @contextmanager
    def as_directory(self):
        yield self._local_path()

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        meta = self.get_metadata()
        meta.update(metadata)
        if self._uri is not None:
            # touch only .metadata.json on the URI filesystem — materializing
            # the whole (possibly multi-GB) checkpoint for one small file
            # would be absurd, and a write into the throwaway fetch cache
            # would be silently lost
            from .storage import resolve

            fs, p = resolve(self._uri)
            with fs.open_output_stream(f"{p.rstrip('/')}/.metadata.json") as f:
                f.write(json.dumps(meta).encode())
            return
        with open(os.path.join(self.path, ".metadata.json"), "w") as f:
            json.dump(meta, f)

    def get_metadata(self) -> Dict[str, Any]:
        if self._uri is not None:
            from .storage import resolve

            fs, p = resolve(self._uri)
            try:
                with fs.open_input_stream(
                        f"{p.rstrip('/')}/.metadata.json") as f:
                    return json.loads(f.read().decode())
            except (FileNotFoundError, OSError):
                return {}
        p = os.path.join(self.path, ".metadata.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def __reduce__(self):
        return (Checkpoint, (self.path,))

    def __repr__(self):
        return f"Checkpoint(path={self.path})"


@dataclasses.dataclass
class CheckpointConfig:
    """Top-k retention — reference ``air/config.py:574``."""
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: Optional[bool] = None


@dataclasses.dataclass
class _TrackedCheckpoint:
    checkpoint: Checkpoint
    metrics: Dict[str, Any]
    index: int


class CheckpointManager:
    """Registers reported checkpoints into the run dir, keeps top-k.

    ``run_dir`` may be a local directory or a pyarrow-filesystem URI
    (reference: StorageContext) — reported local checkpoints upload through
    ``pyarrow.fs`` and are tracked as URI checkpoints."""

    def __init__(self, config: Optional[CheckpointConfig], run_dir: str):
        from .storage import is_uri

        self.config = config or CheckpointConfig()
        self.run_dir = run_dir
        self._remote = is_uri(run_dir)
        self.tracked: List[_TrackedCheckpoint] = []
        self._index = 0

    def register(self, checkpoint: Checkpoint,
                 metrics: Dict[str, Any]) -> Checkpoint:
        name = f"checkpoint_{self._index:06d}"
        if self._remote:
            from pyarrow import fs as pafs

            from .storage import resolve

            dst_fs, root = resolve(self.run_dir)
            dest_fs_path = f"{root.rstrip('/')}/{name}"
            dst_fs.create_dir(dest_fs_path, recursive=True)
            pafs.copy_files(checkpoint.to_directory(), dest_fs_path,
                            source_filesystem=pafs.LocalFileSystem(),
                            destination_filesystem=dst_fs)
            scheme = self.run_dir.split("://", 1)[0]
            registered = Checkpoint(f"{scheme}://{dest_fs_path}")
        else:
            dest = os.path.join(self.run_dir, name)
            if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
                os.makedirs(dest, exist_ok=True)
                shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
            registered = Checkpoint(dest)
        tracked = _TrackedCheckpoint(registered, dict(metrics), self._index)
        self._index += 1
        self.tracked.append(tracked)
        self._enforce_retention()
        return tracked.checkpoint

    def _score(self, t: _TrackedCheckpoint) -> float:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return float(t.index)  # recency
        v = t.metrics.get(attr)
        try:
            v = float(v)
        except (TypeError, ValueError):
            return float("-inf")
        return v if self.config.checkpoint_score_order == "max" else -v

    def _enforce_retention(self) -> None:
        k = self.config.num_to_keep
        if k is None or len(self.tracked) <= k:
            return
        # the most recent is always kept (needed for failure recovery) and
        # counts against the budget; the rest of the k slots go to the best.
        latest = self.tracked[-1]
        ranked = sorted((t for t in self.tracked if t is not latest),
                        key=self._score, reverse=True)
        keep = set(id(t) for t in ranked[:max(k - 1, 0)])
        keep.add(id(latest))
        for t in list(self.tracked):
            if id(t) not in keep:
                if t.checkpoint.uri is not None:
                    from .storage import resolve
                    try:
                        fs, p = resolve(t.checkpoint.uri)
                        fs.delete_dir(p)
                    except OSError:
                        pass
                else:
                    shutil.rmtree(t.checkpoint.path, ignore_errors=True)
                self.tracked.remove(t)

    @property
    def latest(self) -> Optional[Checkpoint]:
        return self.tracked[-1].checkpoint if self.tracked else None

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self.tracked:
            return None
        return max(self.tracked, key=self._score).checkpoint
