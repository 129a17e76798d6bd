"""The filesystem seam: byte-blob storage behind the metadata and index
data paths.

A small byte-blob interface with one implementation, ``PosixFileSystem``:
local disk, where the operation-log claim is ``os.link`` (fails with
EEXIST on an existing target) and writes are temp-file + atomic
replace. The claim makes log-id allocation linearizable, which is the
whole optimistic-concurrency story of the operation log.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

from ..exceptions import PreconditionFailedError


class FileSystem:
    """Minimal byte-blob storage interface — everything the operation log
    and the TCB layout need."""

    # True on backends whose ``write`` honors ``if_generation_match`` and
    # whose ``generation`` returns a monotonic per-object counter. Writers
    # that fence via preconditions (the lease heartbeat) consult this and
    # fall back to unconditioned writes elsewhere.
    supports_generation_preconditions = False

    def create_if_absent(self, path: str, data: bytes) -> bool:
        """Atomically create ``path`` iff it does not exist (the OCC
        claim). True on success, False if already present.

        CONTRACT: claimed payloads must be writer-unique. Backends that
        recover from retried uploads by comparing object bytes (GCS)
        decide ownership by payload equality — byte-identical racing
        claims would both report winning."""
        raise NotImplementedError

    def write(self, path: str, data: bytes, *, if_generation_match=None) -> None:
        """Atomic whole-object write (overwrite allowed).

        ``if_generation_match`` (backends with
        ``supports_generation_preconditions``): the write applies only if
        the object's current generation equals the given value — a
        mismatch raises PreconditionFailedError, a classified PERMANENT
        error. This is how a fenced/stale writer is refused instead of
        silently overwriting newer state. Backends without generations
        raise PreconditionFailedError for any non-None precondition
        rather than pretending to honor it."""
        raise NotImplementedError

    def read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        """Ranged read; ``length=None`` reads to the end."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        """Names of immediate children under ``prefix`` (one level, the
        way the log manager lists numeric entry names)."""
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError


class PosixFileSystem(FileSystem):
    """Local disk. The claim primitive is ``os.link(tmp, target)`` —
    linearizable on POSIX, fails with EEXIST if the target exists (plain
    rename overwrites, so it cannot claim)."""

    def create_if_absent(self, path: str, data: bytes) -> bool:
        from ..exceptions import TransientStorageError

        target = Path(path)
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.parent / f".{target.name}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
        try:
            tmp.write_bytes(data)
            os.link(tmp, target)
            return True
        except FileExistsError:
            return False
        except FileNotFoundError as e:
            # our temp vanished between write and link: an external
            # sweeper (crash-litter GC) mistook it for an orphan. The
            # claim itself was never attempted — classify transient so
            # the retry layer simply re-runs it with a fresh temp.
            raise TransientStorageError(
                f"claim temp for {path} swept mid-claim; retry"
            ) from e
        finally:
            tmp.unlink(missing_ok=True)

    def write(self, path: str, data: bytes, *, if_generation_match=None) -> None:
        if if_generation_match is not None:
            raise PreconditionFailedError(
                "PosixFileSystem has no object generations; preconditioned "
                "writes are refused rather than silently unguarded."
            )
        from ..exceptions import TransientStorageError

        target = Path(path)
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.parent / f".{target.name}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
        try:
            tmp.write_bytes(data)
            os.replace(tmp, target)
        except FileNotFoundError as e:
            # temp swept by an external GC mid-write: transient, retry
            # re-runs with a fresh temp (see create_if_absent)
            raise TransientStorageError(
                f"write temp for {path} swept mid-write; retry"
            ) from e

    def read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length) if length is not None else f.read()

    def exists(self, path: str) -> bool:
        return Path(path).exists()

    def size(self, path: str) -> int:
        return os.path.getsize(path)

    def list(self, prefix: str) -> List[str]:
        p = Path(prefix)
        if not p.is_dir():
            return []
        return sorted(child.name for child in p.iterdir())

    def delete(self, path: str) -> None:
        Path(path).unlink(missing_ok=True)


DEFAULT_FS = PosixFileSystem()
