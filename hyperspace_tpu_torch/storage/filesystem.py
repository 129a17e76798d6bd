"""The filesystem seam: byte-blob storage behind the metadata and index
data paths.

A small byte-blob interface. The operation-log claim is
``create_if_absent``, which makes log-id allocation linearizable: the
whole optimistic-concurrency story of the operation log.

* ``PosixFileSystem`` — local disk; the claim is ``os.link`` (fails with
  EEXIST on an existing target), writes are temp-file + atomic replace;
* ``FakeGcsFileSystem`` — an in-memory object store with GCS semantics:
  flat namespace with prefix listing, per-object generation numbers,
  atomic whole-object PUT, and create-if-absent through the generation-0
  precondition. ``storage/gcs.py``'s ``GcsFileSystem`` speaks the same
  protocol to a real store over HTTP.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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


class FakeGcsFileSystem(FileSystem):
    """In-memory object store with GCS concurrency semantics.

    * flat namespace — "directories" are just name prefixes; ``list``
      returns the next path segment after the prefix, like a delimiter
      query;
    * every object carries a generation number bumped on each overwrite;
    * ``create_if_absent`` is an upload with ``ifGenerationMatch=0``:
      atomic under the store's lock, exactly one concurrent creator wins —
      the linearizable claim the log protocol needs without any rename;
    * ``write`` honors ``if_generation_match=N`` the same way real GCS
      does — a mismatch is HTTP 412, surfaced here as the classified
      PreconditionFailedError. Before this, a fenced/stale writer's
      ``write`` silently overwrote whatever a newer epoch had written,
      which is exactly the lost-update the generation machinery exists
      to prevent (and ``create_if_absent``'s own precondition already
      prevented for creates).
    """

    supports_generation_preconditions = True

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: Dict[str, Tuple[bytes, int]] = {}

    @staticmethod
    def _key(path: str) -> str:
        return str(path).lstrip("/")

    def create_if_absent(self, path: str, data: bytes) -> bool:
        k = self._key(path)
        with self._lock:
            if k in self._objects:
                return False  # ifGenerationMatch=0 precondition failed
            self._objects[k] = (bytes(data), 1)
            return True

    def write(self, path: str, data: bytes, *, if_generation_match=None) -> None:
        k = self._key(path)
        with self._lock:
            gen = self._objects.get(k, (b"", 0))[1]
            if if_generation_match is not None and gen != int(if_generation_match):
                raise PreconditionFailedError(
                    f"generation precondition failed for {path}: "
                    f"expected {if_generation_match}, at {gen}"
                )
            self._objects[k] = (bytes(data), gen + 1)

    def generation(self, path: str) -> int:
        with self._lock:
            obj = self._objects.get(self._key(path))
            return obj[1] if obj else 0

    def read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        k = self._key(path)
        with self._lock:
            if k not in self._objects:
                raise FileNotFoundError(path)
            data = self._objects[k][0]
        end = len(data) if length is None else offset + length
        return data[offset:end]

    def exists(self, path: str) -> bool:
        with self._lock:
            return self._key(path) in self._objects

    def size(self, path: str) -> int:
        k = self._key(path)
        with self._lock:
            if k not in self._objects:
                raise FileNotFoundError(path)
            return len(self._objects[k][0])

    def list(self, prefix: str) -> List[str]:
        pfx = self._key(prefix).rstrip("/") + "/"
        seen = set()
        with self._lock:
            for k in self._objects:
                if k.startswith(pfx):
                    seen.add(k[len(pfx):].split("/", 1)[0])
        return sorted(seen)

    def delete(self, path: str) -> None:
        with self._lock:
            self._objects.pop(self._key(path), None)


DEFAULT_FS = PosixFileSystem()
