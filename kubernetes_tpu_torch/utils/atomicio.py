"""Atomic durable writes — the WAL's commit discipline as ONE helper.

Every durable artifact in the tree (the apiserver's snapshot fold, audit
repro bundles, the AOT executable cache's fingerprint/manifest) commits
the same way: write a temp file in the TARGET directory, flush, fsync,
then ``os.replace`` — the POSIX-atomic rename that makes a reader see
either the old complete file or the new complete file, never a torn
middle. Before this module each site hand-rolled the sequence (and one
had quietly dropped the fsync); now the sequence lives here and
ktpu-lint rule KTL008 flags any ``os.replace``/``os.rename`` commit
outside it.

The temp file is created with ``tempfile.mkstemp`` IN the destination
directory: same filesystem (rename stays atomic, never a cross-device
copy) and a unique name (two writers racing the same path each commit a
complete file; last rename wins, which is the WAL's own semantics).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Union


def atomic_write(path: str, data: Union[bytes, str], *,
                 fsync: bool = True) -> None:
    """Commit ``data`` to ``path`` atomically (temp file + fsync +
    rename). Raises on IO failure — callers own the
    best-effort-vs-fatal decision; a swallowed failed commit here would
    make every durable artifact silently optional."""
    path = os.fspath(path)
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb" if isinstance(data, bytes) else "w") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_publish(tmp: str, path: str) -> None:
    """Commit a file that another process wrote to ``tmp`` (a compiler's
    output, named in ``path``'s directory) over ``path``: fsync, then
    rename. A reader sees the old library or the whole new one."""
    fd = os.open(os.fspath(tmp), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


def atomic_write_json(path: str, payload, *, fsync: bool = True,
                      **json_kwargs) -> None:
    """``atomic_write`` of a JSON document (the shape every current
    durable artifact takes)."""
    atomic_write(path, json.dumps(payload, **json_kwargs), fsync=fsync)
