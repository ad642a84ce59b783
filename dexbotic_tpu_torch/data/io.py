"""Pluggable file IO: the megfile/S3 analogue behind the data layer.

The reference reads every dataset artifact through megfile's smart_* API so
local paths and object stores are interchangeable
(/root/reference/dexbotic/data/dataset/dex_dataset.py:9,294-329,
exp/base_exp.py read_normalization_stats).  This module provides the same
seam with scheme-dispatched drivers:

  * local paths (no scheme or file://) — plain filesystem, zero overhead;
  * mem:// — an in-process dict-backed store for tests and as the model
    driver implementation;
  * any other scheme — registerable via ``register_driver`` (an S3 driver
    plugs in without touching dexdata/multimodal).

Remote media (video) decoders need a real file on disk: ``smart_local_path``
fetches to a temp cache for non-local schemes and is a passthrough locally.
"""

from __future__ import annotations

import fnmatch
import glob as globlib
import io
import os
import tempfile
import threading
from typing import IO


def _split(path: str) -> tuple[str, str]:
    """'s3://bucket/k' -> ('s3', 'bucket/k'); '/x/y' -> ('', '/x/y').
    Windows-style 'C:\\' never reaches here (posix containers)."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        return scheme.lower(), rest
    return "", path


class FileDriver:
    """Driver interface.  Paths arrive WITHOUT the scheme prefix."""

    def open(self, path: str, mode: str = "r") -> IO:
        raise NotImplementedError

    def glob(self, pattern: str, recursive: bool = True) -> list[str]:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def local_path(self, path: str) -> str:
        """A real filesystem path with this file's contents (for decoders
        that cannot stream).  Default: download to a per-process cache."""
        cache = os.path.join(tempfile.gettempdir(), "dexbotic_io_cache")
        os.makedirs(cache, exist_ok=True)
        local = os.path.join(cache, path.replace("/", "_"))
        if not os.path.exists(local):
            with self.open(path, "rb") as src, open(local + ".tmp", "wb") as dst:
                dst.write(src.read())
            os.replace(local + ".tmp", local)
        return local


class LocalDriver(FileDriver):
    def open(self, path, mode="r"):
        return open(path, mode)

    def glob(self, pattern, recursive=True):
        return sorted(globlib.glob(pattern, recursive=recursive))

    def exists(self, path):
        return os.path.exists(path)

    def local_path(self, path):
        return path


class MemDriver(FileDriver):
    """Dict-backed fake-remote store (shared per process, thread-safe)."""

    def __init__(self):
        self._files: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def open(self, path, mode="r"):
        if "w" in mode:
            driver = self

            class _Writer(io.BytesIO):
                def close(self_w):
                    with driver._lock:
                        driver._files[path] = self_w.getvalue()
                    super().close()

            buf = _Writer()
            return io.TextIOWrapper(buf, write_through=True) if "b" not in mode else buf
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(f"mem://{path}")
            data = self._files[path]
        return io.BytesIO(data) if "b" in mode else io.StringIO(data.decode())

    def glob(self, pattern, recursive=True):
        # '**' crosses directory separators like recursive glob
        rx = pattern.replace("**/", "\x00").replace("**", "\x00")
        with self._lock:
            names = list(self._files)
        out = []
        for n in names:
            pat = rx.replace("\x00", "*")
            if fnmatch.fnmatch(n, pat):
                out.append("mem://" + n)
        return sorted(out)

    def exists(self, path):
        with self._lock:
            return path in self._files

    def clear(self):
        with self._lock:
            self._files.clear()


_DRIVERS: dict[str, FileDriver] = {"": LocalDriver(), "file": LocalDriver(),
                                   "mem": MemDriver()}


def register_driver(scheme: str, driver: FileDriver) -> None:
    _DRIVERS[scheme.lower()] = driver


def _driver_for(path: str) -> tuple[FileDriver, str]:
    scheme, rest = _split(path)
    d = _DRIVERS.get(scheme)
    if d is None:
        raise ValueError(f"no IO driver registered for scheme {scheme!r} ({path})")
    return d, rest


def smart_open(path: str, mode: str = "r") -> IO:
    d, rest = _driver_for(path)
    return d.open(rest, mode)


def smart_glob(pattern: str, recursive: bool = True) -> list[str]:
    d, rest = _driver_for(pattern)
    return d.glob(rest, recursive=recursive)


def smart_exists(path: str) -> bool:
    d, rest = _driver_for(path)
    return d.exists(rest)


def smart_local_path(path: str) -> str:
    d, rest = _driver_for(path)
    return d.local_path(rest)


def smart_join(base: str, *parts: str) -> str:
    """os.path.join that preserves a scheme prefix."""
    scheme, rest = _split(base)
    joined = os.path.join(rest, *parts)
    return f"{scheme}://{joined}" if scheme else joined
