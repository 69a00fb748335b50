"""Storage context: checkpoints on any pyarrow filesystem.

Reference: ``train/_internal/storage.py:350`` (StorageContext — a
``pyarrow.fs`` URI + consistent experiment layout shared by head and
workers).  ``storage_path`` may be a plain local path or any URI pyarrow
resolves (``file://``, ``s3://``, ``gs://``, ``hdfs://``, ``mock://`` in
tests); checkpoint uploads/downloads go through ``pyarrow.fs.copy_files`` so
the same code path serves local disk and cloud buckets.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple


def resolve(path_or_uri: str) -> Tuple[object, str]:
    """-> (pyarrow FileSystem, path on that filesystem)."""
    from pyarrow import fs as pafs

    if "://" in path_or_uri:
        return pafs.FileSystem.from_uri(path_or_uri)
    return pafs.LocalFileSystem(), os.path.abspath(
        os.path.expanduser(path_or_uri))


def is_uri(path: str) -> bool:
    return "://" in path


class StorageContext:
    """One experiment's storage root + helpers (upload/fetch/delete)."""

    def __init__(self, storage_path: str, experiment_name: str):
        self.storage_path = storage_path
        self.experiment_name = experiment_name
        self.fs, fs_root = resolve(storage_path)
        self.experiment_fs_path = self._join(fs_root, experiment_name)
        self.fs.create_dir(self.experiment_fs_path, recursive=True)

    @staticmethod
    def _join(*parts: str) -> str:
        return "/".join(p.strip("/") if i else p.rstrip("/")
                        for i, p in enumerate(parts))

    def fs_path(self, *rel: str) -> str:
        return self._join(self.experiment_fs_path, *rel)

    def uri(self, *rel: str) -> str:
        if is_uri(self.storage_path):
            scheme = self.storage_path.split("://", 1)[0]
            return f"{scheme}://{self.fs_path(*rel)}"
        return self.fs_path(*rel)

    # -------------------------------------------------------------- copies

    def upload_dir(self, local_dir: str, *rel: str) -> str:
        """Local directory -> storage; returns the destination fs path."""
        from pyarrow import fs as pafs

        dest = self.fs_path(*rel)
        self.fs.create_dir(dest, recursive=True)
        pafs.copy_files(local_dir, dest,
                        source_filesystem=pafs.LocalFileSystem(),
                        destination_filesystem=self.fs)
        return dest

    def download_dir(self, rel_or_fs_path: str,
                     local_dir: Optional[str] = None) -> str:
        """Storage directory -> local; returns the local path."""
        from pyarrow import fs as pafs

        src = (rel_or_fs_path
               if rel_or_fs_path.startswith(self.experiment_fs_path)
               else self.fs_path(rel_or_fs_path))
        local_dir = local_dir or tempfile.mkdtemp(prefix="raytpu-fetch-")
        os.makedirs(local_dir, exist_ok=True)
        pafs.copy_files(src, local_dir, source_filesystem=self.fs,
                        destination_filesystem=pafs.LocalFileSystem())
        return local_dir

    def delete_dir(self, *rel: str) -> None:
        try:
            self.fs.delete_dir(self.fs_path(*rel))
        except (FileNotFoundError, OSError):
            pass

    def exists(self, *rel: str) -> bool:
        from pyarrow import fs as pafs

        info = self.fs.get_file_info(self.fs_path(*rel))
        return info.type != pafs.FileType.NotFound
