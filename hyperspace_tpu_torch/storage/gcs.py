"""GCS backend for the FileSystem seam — a raw JSON-API client.

Counterpart of ``hyperspace_tpu.storage.gcs``. The reference talks to
object stores through Hadoop's FileSystem implementations
(IndexLogManager.scala:149-165 relies on the store's rename/claim
semantics). GCS has no rename; the linearizable
claim the operation log needs is an upload with ``ifGenerationMatch=0`` —
exactly one concurrent creator succeeds, the rest get HTTP 412. This
client implements the seam's seven methods over the GCS JSON API v1 with
nothing but the standard library (no SDK in the image, and none needed:
the protocol surface is seven small HTTP calls).

* uploads: ``POST /upload/storage/v1/b/{bucket}/o?uploadType=media``
  (+``ifGenerationMatch=0`` for the claim);
* reads: ``GET .../o/{object}?alt=media`` with a ``Range`` header;
* metadata / existence: ``GET .../o/{object}?fields=size,generation``;
* listing: ``GET .../o?prefix=..&delimiter=/`` (paginated), returning
  immediate children the way the log manager lists numeric entry names;
* transient failures (429/5xx) retry with exponential backoff, per the
  GCS error-handling contract; 412 is a *result* (claim lost), never an
  error.

Auth is a pluggable ``token_provider`` callable returning a bearer token
(metadata-server lookup in production; tests run an anonymous local fake
server via ``endpoint=``). tests/test_torch_gcs.py runs the protocol
against this client talking to a local HTTP server — the same claim-once, log-protocol and TCB byte
round-trip checks the POSIX and in-memory backends pass.
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, List, Optional

from ..exceptions import PreconditionFailedError
from ..telemetry.metrics import metrics
from .filesystem import FileSystem

_RETRYABLE = {429, 500, 502, 503, 504}


class GcsFileSystem(FileSystem):
    supports_generation_preconditions = True
    # every RPC already retries transient statuses/socket failures inside
    # _request (with self-win handling on claims); the seam-level
    # RetryingFileSystem must not wrap another retry loop around it —
    # that would multiply attempts (~max_retries²) and compound backoff
    # during an outage (reliability.retry.wrap_with_retries honors this)
    has_internal_retries = True

    def __init__(
        self,
        bucket: str,
        endpoint: str = "https://storage.googleapis.com",
        token_provider: Optional[Callable[[], str]] = None,
        timeout: float = 30.0,
        max_retries: int = 4,
        retry_policy=None,
    ):
        from ..reliability.retry import RetryPolicy

        self.bucket = bucket
        self.endpoint = endpoint.rstrip("/")
        self.token_provider = token_provider
        self.timeout = timeout
        self.max_retries = max_retries
        # shared backoff shape with the seam-level RetryingFileSystem:
        # bounded exponential + deterministic jitter keyed on the URL, so
        # a herd of clients hammering one hot object de-synchronizes
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=max_retries + 1
        )

    # -- plumbing ------------------------------------------------------------
    def _key(self, path: str) -> str:
        p = str(path)
        if p.startswith("gs://"):
            bucket, _, obj = p[5:].partition("/")
            if bucket != self.bucket:
                raise ValueError(
                    f"path {path!r} names bucket {bucket!r} but this client "
                    f"is bound to {self.bucket!r}"
                )
            p = obj
        return p.lstrip("/")

    def _headers(self) -> dict:
        h = {}
        if self.token_provider is not None:
            h["Authorization"] = f"Bearer {self.token_provider()}"
        return h

    def _request(
        self,
        method: str,
        url: str,
        data: Optional[bytes] = None,
        headers: Optional[dict] = None,
        ok: tuple = (200,),
        expect: tuple = (),
        retried_out: Optional[list] = None,
    ):
        """One HTTP call with bounded retries on transient statuses.
        Statuses in ``expect`` are returned as (status, body) instead of
        raising — preconditions and 404s are protocol results here.
        ``retried_out`` (a list) gets True appended when any
        connection-level retry happened — callers of non-idempotent
        operations need to know the response may belong to a second
        attempt."""
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            req = urllib.request.Request(
                url, data=data, method=method,
                headers={**self._headers(), **(headers or {})},
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                body = e.read()
                if e.code in ok or e.code in expect:
                    return e.code, body
                if e.code in _RETRYABLE and attempt < self.max_retries:
                    last = e
                    if retried_out is not None:
                        # a 5xx may have been emitted AFTER the server (or
                        # a proxy) applied the upload — claims must run
                        # self-win detection on the retry's 412 too
                        retried_out.append(True)
                    metrics.incr("storage.retry.attempts")
                    metrics.incr("storage.retry.gcs_http")
                    time.sleep(self.retry_policy.delay_for(attempt + 1, url))
                    continue
                raise OSError(
                    f"GCS {method} {url} -> {e.code}: {body[:200]!r}"
                ) from e
            except (
                urllib.error.URLError,
                ConnectionError,
                TimeoutError,
                http.client.HTTPException,  # e.g. IncompleteRead mid-body
            ) as e:
                # raw socket failures (reset, refused, timeout) retry like
                # 5xx; the retry is reported via retried_out so claims can
                # run self-win detection (see create_if_absent)
                if attempt < self.max_retries:
                    last = e
                    if retried_out is not None:
                        retried_out.append(True)
                    metrics.incr("storage.retry.attempts")
                    metrics.incr("storage.retry.gcs_conn")
                    time.sleep(self.retry_policy.delay_for(attempt + 1, url))
                    continue
                raise OSError(f"GCS {method} {url} unreachable: {e}") from e
        raise OSError(f"GCS {method} {url} failed after retries: {last}")

    def _obj_url(self, name: str, **params) -> str:
        q = urllib.parse.urlencode(params)
        return (
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o/"
            f"{urllib.parse.quote(name, safe='')}" + (f"?{q}" if q else "")
        )

    def _upload_url(self, name: str, **params) -> str:
        q = urllib.parse.urlencode(
            {"uploadType": "media", "name": name, **params}
        )
        return f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o?{q}"

    # -- seam ----------------------------------------------------------------
    def create_if_absent(self, path: str, data: bytes) -> bool:
        """Atomic claim via ``ifGenerationMatch=0``.

        CONTRACT: callers must make claimed payloads writer-unique. The
        self-win detection below decides ownership by byte equality after
        a retried upload, so two racers claiming with byte-identical
        payloads could both conclude they won. The operation-log writer
        satisfies this today (entries embed writer-distinct state:
        timestamps, uuid-named data dirs); any new claim site must carry
        a per-writer nonce if its payloads could collide."""
        retried: list = []
        status, _ = self._request(
            "POST",
            self._upload_url(self._key(path), ifGenerationMatch=0),
            data=bytes(data),
            headers={"Content-Type": "application/octet-stream"},
            expect=(412,),  # precondition failed = claim lost, not an error
            retried_out=retried,
        )
        if status != 412:
            return True
        if retried:
            # self-win detection: a connection reset AFTER the server
            # applied our upload makes the retry see 412 — misreporting
            # our own claim as lost would strand an ownerless log entry
            # at this id. If the object's bytes are ours, the claim stood.
            try:
                return self.read(path) == bytes(data)
            except FileNotFoundError:
                return False
        return False

    def write(self, path: str, data: bytes, *, if_generation_match=None) -> None:
        params = {}
        if if_generation_match is not None:
            params["ifGenerationMatch"] = int(if_generation_match)
        retried: list = []
        status, _ = self._request(
            "POST",
            self._upload_url(self._key(path), **params),
            data=bytes(data),
            headers={"Content-Type": "application/octet-stream"},
            expect=(412,) if if_generation_match is not None else (),
            retried_out=retried,
        )
        if status == 412:
            if retried:
                # self-win detection (same as create_if_absent): a reset
                # AFTER the server applied our preconditioned write makes
                # the retry see 412 against its own generation bump
                try:
                    if self.read(path) == bytes(data):
                        return
                except FileNotFoundError:
                    pass
            raise PreconditionFailedError(
                f"generation precondition failed for {path}: "
                f"expected {if_generation_match}"
            )

    def read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        if length == 0:
            # an empty Range ('bytes=5-4') is invalid HTTP; real GCS would
            # ignore it and return the WHOLE object — match the other
            # backends' b'' without a request
            if not self.exists(path):
                raise FileNotFoundError(path)
            return b""
        headers = {}
        if offset or length is not None:
            end = "" if length is None else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        status, body = self._request(
            "GET",
            self._obj_url(self._key(path), alt="media"),
            headers=headers,
            ok=(200, 206),
            expect=(404, 416),
        )
        if status == 404:
            raise FileNotFoundError(path)
        if status == 416:  # range beyond the object: empty, like a file read
            return b""
        return body

    def _metadata(self, path: str) -> Optional[dict]:
        status, body = self._request(
            "GET",
            self._obj_url(self._key(path), fields="size,generation"),
            expect=(404,),
        )
        if status == 404:
            return None
        return json.loads(body)

    def exists(self, path: str) -> bool:
        return self._metadata(path) is not None

    def size(self, path: str) -> int:
        meta = self._metadata(path)
        if meta is None:
            raise FileNotFoundError(path)
        return int(meta["size"])

    def generation(self, path: str) -> int:
        meta = self._metadata(path)
        return int(meta["generation"]) if meta else 0

    def list(self, prefix: str) -> List[str]:
        pfx = self._key(prefix).rstrip("/") + "/"
        children: set = set()
        page: Optional[str] = None
        while True:
            params = {
                "prefix": pfx,
                "delimiter": "/",
                "fields": "items(name),prefixes,nextPageToken",
            }
            if page:
                params["pageToken"] = page
            url = (
                f"{self.endpoint}/storage/v1/b/{self.bucket}/o?"
                + urllib.parse.urlencode(params)
            )
            _, body = self._request("GET", url)
            payload = json.loads(body) if body else {}
            for item in payload.get("items", []):
                name = item["name"][len(pfx):]
                if name:
                    children.add(name)
            for p in payload.get("prefixes", []):
                children.add(p[len(pfx):].rstrip("/"))
            page = payload.get("nextPageToken")
            if not page:
                return sorted(children)

    def delete(self, path: str) -> None:
        self._request(
            "DELETE",
            self._obj_url(self._key(path)),
            ok=(200, 204),
            expect=(404,),  # absent = already deleted (idempotent)
        )
