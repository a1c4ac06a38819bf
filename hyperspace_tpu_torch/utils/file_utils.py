"""Filesystem utilities: local/posix fast paths + fsspec URLs.

Parity: reference `util/FileUtils.scala:37-116` (createFile, readContents,
getDirectorySize, createDirectory, delete, save/loadByteArray) — the
reference goes through the Hadoop FileSystem API, which is what lets it
run on HDFS/ABFS unchanged; here plain paths use os/posix directly and
`scheme://` paths route through fsspec (`utils/storage.py`). Atomicity
helpers used by the op log's optimistic concurrency live here too.
"""

from __future__ import annotations

import os
import shutil
import uuid

from hyperspace_tpu_torch.utils import faults, storage


def create_file(path: str, contents: str) -> None:
    directive = faults.fire("file.create", path)
    data = contents.encode("utf-8")
    if directive == faults.TORN:
        # Writer "dies" mid-write: a prefix of the payload lands.
        data = data[:max(1, len(data) // 2)]
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        fs.makedirs(os.path.dirname(real), exist_ok=True)
        with fs.open(real, "wb") as f:
            f.write(data)
    else:
        create_directory(os.path.dirname(path))
        with open(path, "wb") as f:
            f.write(data)
    if directive == faults.TORN:
        raise faults.TornWriteError(f"injected torn write at {path}")


def read_contents(path: str) -> str:
    faults.fire("file.read", path)
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        with fs.open(real, "rb") as f:
            return f.read().decode("utf-8")
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def get_directory_size(path: str) -> int:
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        if not fs.exists(real):
            return 0
        return sum(info.get("size", 0) or 0
                   for info in fs.find(real, detail=True).values())
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            total += os.path.getsize(os.path.join(root, name))
    return total


def create_directory(path: str) -> None:
    if not path:
        return
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        fs.makedirs(real, exist_ok=True)
        return
    os.makedirs(path, exist_ok=True)


def exists(path: str) -> bool:
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        return fs.exists(real)
    return os.path.exists(path)


def is_dir(path: str) -> bool:
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        return fs.isdir(real)
    return os.path.isdir(path)


def is_file(path: str) -> bool:
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        return fs.isfile(real)
    return os.path.isfile(path)


def delete(path: str) -> None:
    faults.fire("file.delete", path)
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        if fs.exists(real):
            fs.rm(real, recursive=True)
        return
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        os.remove(path)


def remove_file(path: str) -> None:
    faults.fire("file.delete", path)
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        fs.rm_file(real)
        return
    os.remove(path)


def save_byte_array(path: str, data: bytes) -> None:
    faults.fire("file.write", path)
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        fs.makedirs(os.path.dirname(real), exist_ok=True)
        with fs.open(real, "wb") as f:
            f.write(data)
        return
    create_directory(os.path.dirname(path))
    with open(path, "wb") as f:
        f.write(data)


def load_byte_array(path: str) -> bytes:
    faults.fire("file.read", path)
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        with fs.open(real, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def atomic_publish(path: str, contents: str) -> None:
    """Publish `contents` at `path` so that a concurrent reader observes
    either the previous contents or the new ones IN FULL — never a torn
    mix. Local filesystems write a temp file (fsynced) and `os.replace`
    it over the target (atomic on POSIX, overwrite allowed — unlike the
    OCC primitive above, which must FAIL on an existing target). URL
    paths publish with a single object put: object stores materialize an
    object only when its upload completes, and the in-process memory fs
    swaps the buffer under the GIL, so a plain streamed open/write (which
    CAN tear on some backends) is avoided.

    Used for `latestStable`: it is a rewritten-in-place convenience copy,
    the one log file whose readers do not tolerate torn contents via the
    OCC torn-read retry (a half-written id file is retried until its
    writer finishes; a half-written latestStable used to parse as
    corruption)."""
    data = contents.encode("utf-8")
    directive = faults.fire("file.publish", path)
    if storage.is_url(path):
        fs, real = storage.get_fs(path)
        fs.makedirs(os.path.dirname(real), exist_ok=True)
        if directive == faults.TORN:
            # The torn upload never completes: no object materializes,
            # the previous one (if any) stays intact.
            raise faults.TornWriteError(f"injected torn publish at {path}")
        fs.pipe_file(real, data)
        return
    create_directory(os.path.dirname(path))
    tmp = path + ".tmp" + uuid.uuid4().hex
    try:
        with open(tmp, "wb") as f:
            if directive == faults.TORN:
                f.write(data[:max(1, len(data) // 2)])
                f.flush()
                os.fsync(f.fileno())
                raise faults.TornWriteError(
                    f"injected torn publish at {path}")
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass


def atomic_write_if_absent(path: str, contents: str,
                           single_writer: bool = False) -> bool:
    """Write `contents` to `path` only if `path` does not already exist.

    This is the op log's optimistic-concurrency primitive: the reference
    writes a `temp<UUID>` file and atomically renames it, treating rename
    failure as "a concurrent writer won" (`index/IndexLogManager.scala:139-156`).
    POSIX rename overwrites, so the atomic publish here is `os.link` (hard
    link creation fails with EEXIST if the target exists) with an
    O_CREAT|O_EXCL fallback for filesystems without hard links. URL paths
    go through `storage.exclusive_create`, which uses each backend's REAL
    create precondition (GCS generation match, S3 conditional put) and
    RAISES on backends that have none — unless `single_writer` (the
    `spark.hyperspace.single.writer` conf) explicitly accepts
    check-then-create semantics.
    Returns True iff this caller won the write.
    """
    faults.fire("file.write_if_absent", path)
    if storage.is_url(path):
        from hyperspace_tpu_torch.exceptions import HyperspaceException
        try:
            return storage.exclusive_create(path, contents.encode("utf-8"))
        except storage.PreconditionUnsupported as exc:
            if not single_writer:
                raise HyperspaceException(str(exc)) from exc
            fs, real = storage.get_fs(path)
            fs.makedirs(os.path.dirname(real), exist_ok=True)
            if fs.exists(real):
                return False
            with fs.open(real, "wb") as f:
                f.write(contents.encode("utf-8"))
            return True
    create_directory(os.path.dirname(path))
    tmp = path + ".temp" + uuid.uuid4().hex
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(contents)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.link(tmp, path)
        return True
    except FileExistsError:
        return False
    except OSError:
        # Filesystem without hard-link support: fall back to exclusive
        # create. This publishes the filename before its contents are
        # visible, so readers must tolerate a torn read (see
        # IndexLogManagerImpl.get_log's retry); contents are fsynced before
        # the winner returns.
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(contents)
            f.flush()
            os.fsync(f.fileno())
        return True
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass
