"""HyperspaceSession: the framework's session object (the SparkSession
analog) — holds config, the source providers, the catalog of named views
and tables, and the index-collection manager. ``session.read`` builds
DataFrames; the Hyperspace facade (hyperspace.py) manages indexes against
this session.

The session's device comes from conf ``hyperspace.torch.device``
(default ``cuda``); constructing a session with cuda requested on a
machine without it raises, as every engine entry point does.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from . import constants as C
from .config import HyperspaceConf
from .ops import resolve_device
from .sources.manager import FileBasedSourceProviderManager


class Catalog:
    """Named relations — the catalog-table/temp-view surface the
    reference exercises through Spark's catalog
    (E2EHyperspaceRulesTest.scala "catalog temp tables/views" /
    "managed catalog tables"). Two kinds of entries, both
    case-insensitive like the reference's resolver:

    * **views** bind a name to a DataFrame's LOGICAL PLAN (Spark's
      ``createOrReplaceTempView``): the stored plan is exactly what the
      path-based read produced, so signature matching and the rewrite
      rules fire identically on ``session.table(name)``;
    * **tables** bind a name to a (format, paths, options) source
      registration resolved at read time — a fresh file listing per
      query, so appends/deletes show up the way re-reading a path does.
    """

    def __init__(self, session: "HyperspaceSession"):
        self._session = session
        # one lock over both maps: a concurrent register/drop during
        # serving raced the plain-dict mutations (check-then-act in
        # create_table, the two-step pop in drop) — every entry/exit goes
        # through it, and resolution copies the entry out before building
        # a DataFrame so no IO runs under the lock
        self._lock = threading.RLock()
        self._views: Dict[str, object] = {}  # lower name -> LogicalPlan
        self._tables: Dict[str, tuple] = {}  # lower name -> (fmt, paths, opts)

    # -- registration --------------------------------------------------------
    def create_or_replace_temp_view(self, name: str, df) -> None:
        from .exceptions import HyperspaceException

        if df.session is not self._session:
            # table() re-tags the stored plan with THIS session; accepting
            # a foreign DataFrame would launder it past DataFrame.join's
            # cross-session guard
            raise HyperspaceException(
                "Cannot register a view over a DataFrame from a different "
                "session."
            )
        with self._lock:
            self._tables.pop(name.lower(), None)
            self._views[name.lower()] = df.plan

    def create_table(
        self,
        name: str,
        *paths: str,
        file_format: str = "parquet",
        replace: bool = False,
        **options: str,
    ) -> None:
        from .exceptions import HyperspaceException

        key = name.lower()
        with self._lock:
            if not replace and (key in self._tables or key in self._views):
                raise HyperspaceException(f"Relation {name!r} already exists.")
            self._views.pop(key, None)
            self._tables[key] = (file_format, list(paths), dict(options))

    def drop(self, name: str) -> bool:
        key = name.lower()
        with self._lock:
            return (
                self._views.pop(key, None) is not None
                or self._tables.pop(key, None) is not None
            )

    def list(self) -> List[str]:
        with self._lock:
            return sorted([*self._views, *self._tables])

    # -- resolution ----------------------------------------------------------
    def table(self, name: str):
        from .dataframe import DataFrame
        from .exceptions import HyperspaceException

        key = name.lower()
        with self._lock:
            if key in self._views:
                plan = self._views[key]
                entry = None
            elif key in self._tables:
                plan = None
                entry = self._tables[key]
            else:
                raise HyperspaceException(f"Unknown table or view: {name!r}.")
        if plan is not None:
            return DataFrame(self._session, plan)
        fmt, paths, options = entry
        reader = self._session.read
        for k, v in options.items():
            reader = reader.option(k, v)
        return reader._load(fmt, list(paths))


class HyperspaceSession:
    def __init__(self, conf: Optional[HyperspaceConf] = None):
        self.conf = conf or HyperspaceConf()
        self.device = resolve_device(self.conf.torch_device())
        # the segment-IO mode (hyperspace.storage.segmentIo) becomes the
        # process default, as in the reference: the planner runs on
        # process-global read paths; the typed accessor raises on a typo
        if self.conf.contains(C.STORAGE_SEGMENT_IO):
            from .storage import layout as _layout

            _layout.set_segment_io_default(self.conf.segment_io_mode())
        # the flight recorder's bounds (process-global rings: the last
        # session constructed wins, as in the reference)
        from .telemetry.recorder import adopt_conf as adopt_recorder_conf

        adopt_recorder_conf(self.conf)
        self.sources = FileBasedSourceProviderManager(self.conf)
        self.catalog = Catalog(self)
        self._hyperspace_enabled = False
        self._collection_manager = None  # lazy (circular import)
        # the last finished query's trace (telemetry.trace.QueryTrace): the
        # one record explain(verbose)'s last-query sections render from
        self.last_trace = None
        self._server = None  # lazy QueryServer (serve())
        self._server_lock = threading.Lock()

    # -- last-query attribution (all read from last_trace) --------------------
    @property
    def last_query_metrics(self) -> Optional[dict]:
        """The last query's scoped metrics, from its trace."""
        t = self.last_trace
        return None if t is None else t.meta.get("metrics")

    @property
    def last_serve_info(self) -> Optional[dict]:
        """Tenant and pinned log version of the last query, when the serve
        tier ran it."""
        t = self.last_trace
        return None if t is None else t.meta.get("serve")

    @property
    def last_pipeline_info(self) -> Optional[dict]:
        """The compiled pipeline the last query rode (None when the
        interpreter served it)."""
        t = self.last_trace
        return None if t is None else t.meta.get("pipeline")

    def last_traces(self, n: Optional[int] = None):
        """The flight recorder's most recent completed traces, newest
        first."""
        from .telemetry.recorder import flight_recorder

        return flight_recorder.last(n)

    def serve(self, **options):
        """The session's query server (``serve.QueryServer``), created on
        the first call; ``options`` are ServeConfig fields and apply only
        to that creation. It admits concurrent queries per tenant,
        micro-batches compatible resident scans into one launch, and
        caches optimized plans across queries."""
        with self._server_lock:
            if self._server is None or self._server.closed:
                from .serve import QueryServer, ServeConfig

                self._server = QueryServer(self, ServeConfig(**options))
            elif options:
                from .exceptions import HyperspaceException

                raise HyperspaceException(
                    "serve() options apply only when the server is created; "
                    "close() the running server first."
                )
            return self._server

    def submit(self, df, deadline_s: Optional[float] = None, tenant: Optional[str] = None):
        """``serve().submit(df, deadline_s, tenant)`` (None: the default
        tenant); returns the QueryTicket."""
        if tenant is None:
            from .serve.tenancy import DEFAULT_TENANT

            tenant = DEFAULT_TENANT
        return self.serve().submit(df, deadline_s=deadline_s, tenant=tenant)

    def doctor(self, repair: bool = False, include_traces: bool = False):
        """fsck this session's index system path: log-chain integrity,
        data-file presence and crash litter (orphaned temp files, torn
        builds, stale leases); ``repair=True`` rolls back abandoned writers
        and vacuums orphans. ``include_traces=True`` attaches the flight
        recorder's dump. Returns a DoctorReport (reliability.doctor)."""
        from .reliability.doctor import doctor

        return doctor(
            self.conf.system_path(),
            repair=repair,
            conf=self.conf,
            include_traces=include_traces,
        )

    def table(self, name: str):
        """DataFrame over a registered view or table (Catalog.table)."""
        return self.catalog.table(name)

    # -- rewrite toggle (package.scala:47-79) --------------------------------
    def enable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = True
        return self

    def disable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = False
        return self

    def is_hyperspace_enabled(self) -> bool:
        return self._hyperspace_enabled

    # -- managers ------------------------------------------------------------
    @property
    def collection_manager(self):
        if self._collection_manager is None:
            from .index.collection_manager import CachingIndexCollectionManager

            self._collection_manager = CachingIndexCollectionManager(self)
        return self._collection_manager

    # -- IO ------------------------------------------------------------------
    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)


class DataFrameReader:
    def __init__(self, session: HyperspaceSession):
        self._session = session
        self._options: Dict[str, str] = {}
        self._schema: Optional[Dict[str, str]] = None

    def option(self, key: str, value: str) -> "DataFrameReader":
        self._options[key] = value
        return self

    def schema(self, schema: Dict[str, str]) -> "DataFrameReader":
        self._schema = schema
        return self

    def _load(self, file_format: str, paths: List[str]):
        from .dataframe import DataFrame
        from .plan.ir import Scan

        rel = self._session.sources.create_relation(
            list(paths), file_format, self._options, self._schema
        )
        return DataFrame(self._session, Scan(rel))

    def parquet(self, *paths: str):
        return self._load("parquet", list(paths))

    def csv(self, *paths: str):
        return self._load("csv", list(paths))

    def json(self, *paths: str):
        return self._load("json", list(paths))

    def orc(self, *paths: str):
        return self._load("orc", list(paths))

    def avro(self, *paths: str):
        return self._load("avro", list(paths))

    def text(self, *paths: str):
        return self._load("text", list(paths))

    def format(self, file_format: str):
        fmt = file_format

        class _Loader:
            def load(_self, *paths: str):
                return self._load(fmt, list(paths))

        return _Loader()
