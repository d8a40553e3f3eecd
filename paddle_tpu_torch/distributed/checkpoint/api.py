"""The checkpoint commit protocol's sentinel (the subset of
paddle_tpu/distributed/checkpoint/api.py that serving's weight hot-swap
reads): `COMMITTED_SENTINEL`, `is_committed`, `write_commit_sentinel`
and `commit_generation`. The sentinel holds the same JSON as the
reference's, written the same way (a temporary file, fsync, rename, then
the directory's fsync), so a directory committed by either package is
accepted by the other. Saving and loading tensors come with the
checkpointing slice."""
from __future__ import annotations

import json
import os
import time
import uuid

__all__ = ["COMMITTED_SENTINEL", "CheckpointError",
           "CheckpointNotCommittedError", "is_committed",
           "write_commit_sentinel", "commit_generation"]

COMMITTED_SENTINEL = "_COMMITTED"
MANIFEST_FORMAT = 1


class CheckpointError(RuntimeError):
    """Base class for checkpoint integrity and commit errors."""


class CheckpointNotCommittedError(CheckpointError):
    """The directory has no `_COMMITTED` sentinel: the save never
    committed, so its contents may be torn."""


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse a directory fsync
    finally:
        os.close(fd)


def _atomic_write(path, data):
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def is_committed(path) -> bool:
    """True if `path` holds a committed checkpoint."""
    return os.path.exists(os.path.join(path, COMMITTED_SENTINEL))


def write_commit_sentinel(path, *, world_size=1, generation=None):
    """Write the `_COMMITTED` sentinel, the last step of a commit.
    `generation`, when given, is the monotonic commit id that
    `commit_generation` reads back without loading anything else."""
    sentinel = {"format": MANIFEST_FORMAT, "world_size": int(world_size),
                # wall clock on purpose: it tells operators when the
                # snapshot was committed
                "unix_time": time.time()}
    if generation is not None:
        sentinel["generation"] = int(generation)
    _atomic_write(os.path.join(path, COMMITTED_SENTINEL),
                  json.dumps(sentinel).encode())
    _fsync_dir(path)


def _check_committed(path):
    """Refuse a missing or uncommitted directory; returns the sentinel."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path!r}")
    if not is_committed(path):
        raise CheckpointNotCommittedError(
            f"checkpoint at {path!r} has no {COMMITTED_SENTINEL} sentinel: "
            f"the save never committed and the directory may be torn")
    try:
        with open(os.path.join(path, COMMITTED_SENTINEL)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def commit_generation(path):
    """The generation recorded in the `_COMMITTED` sentinel, or None when
    the commit has none (or the sentinel is unreadable). An uncommitted
    directory raises `CheckpointNotCommittedError`."""
    gen = _check_committed(path).get("generation")
    return None if gen is None else int(gen)
