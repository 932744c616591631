"""
The transform archive: an sqlite database of timing facts keyed by the
*canonicalized* einsum.

The schema (v6: one table ``FEINSUM_TIMING_FACTS`` with columns subscripts,
index_to_length, args, arg_to_dtype, device_name, transform_id,
transform_params, runtime_in_sec, compiler_version, giga_op_info,
timestamp), the table names and the JSON dumps are those of
``feinsum_tpu.sql_utils``, so an archive written by either package reads
alike in both.  What differs:

* ``device_name`` is the key of :func:`~feinsum_tpu_torch.data.device_info.
  get_device_key`: the sanitized CUDA card name (``NVIDIA_H100_80GB_HBM3``),
  ``cpu`` for host timings, or a :class:`~feinsum_tpu_torch.cl_utils.
  FakeDevice`'s name when reading another device's facts;
* ``compiler_version`` records the torch and CUDA versions and the timing
  protocol (:data:`TIMING_PROTOCOL_TAG`);
* a fact's ``transform_id`` names a module of this package's
  ``tuning/impls``, which :attr:`QueryInfo.transform` binds.

:data:`DEFAULT_DB` is this package's own file under ``data/``; it is created
empty on the first write.  The archive is the tuner's checkpoint: every
measured point is inserted at once, and a restarted run seeds from the rows
there and skips the configurations they hold.
"""

from __future__ import annotations

import json
import os
import sqlite3
from dataclasses import dataclass
from datetime import datetime, timezone
from functools import cached_property
from typing import Any, Callable, Optional

import numpy as np

from . import tracing
from .canonicalization import canonicalize_einsum
from .data.device_info import get_device_key
from .diagnostics import NoFactInDatabaseError
from .einsum import INT_CLASSES, BatchedEinsum

DEFAULT_DB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "transform_archive_v1_h100.sqlite")
TIMINGS_TABLENAME = "FEINSUM_TIMING_FACTS"
RETIRED_TABLENAME = "FEINSUM_RETIRED_FACTS"

# The timing protocol of this package's rows, appended to their
# compiler_version: the median of 20 launches, each timed by its own pair of
# CUDA events (measure.timeit_cuda).  The reference's current protocol tag
# is "timing-proto3" (a TPU device-trace span).  Re-timed copies of a
# configuration are aggregated over the rows of a current protocol only.
TIMING_PROTOCOL_TAG = "timing-cuda-events1"
CURRENT_PROTOCOL_TAGS = (TIMING_PROTOCOL_TAG, "timing-proto3")


# {{{ dumps/loads (the formats of feinsum_tpu.sql_utils)

def dump_arg_to_dtype(einsum: BatchedEinsum) -> str:
    return json.dumps({a: dt.name for a, dt in einsum.arg_to_dtype.items()},
                      sort_keys=True)


def dump_index_to_length(einsum: BatchedEinsum) -> str:
    return json.dumps({k: int(v)
                       for k, v in einsum.index_to_dim_length.items()
                       if isinstance(v, INT_CLASSES)}, sort_keys=True)


def dump_arg_names(einsum: BatchedEinsum) -> str:
    return json.dumps([[a.name for a in row] for row in einsum.args])


def dump_compiler_version() -> str:
    import torch
    return (f"torch-{torch.__version__}-cuda-{torch.version.cuda}"
            f"-{TIMING_PROTOCOL_TAG}")


def dump_op_info(einsum: BatchedEinsum, long_dim_length: int) -> str:
    from .measure import evaluate_giga_op_map, get_giga_op_map
    vals = evaluate_giga_op_map(get_giga_op_map(einsum), long_dim_length)
    return json.dumps(vals, sort_keys=True)


def load_op_info(op_info: str) -> dict:
    return {np.dtype(k): v for k, v in json.loads(op_info).items()}


def _process_param(v: Any) -> Any:
    if isinstance(v, (bool, int)):
        return v
    if isinstance(v, list):
        return tuple(_process_param(x) for x in v)
    raise NotImplementedError(type(v))


def load_transform_params(params_str: str) -> dict:
    raw = json.loads(params_str)
    if not isinstance(raw, dict):
        raise ValueError(f"transform_params is not a JSON object:"
                         f" {params_str!r}")
    return {k: _process_param(v) for k, v in raw.items()}


def _jsonify(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, tuple):
        return list(v)
    raise TypeError(type(v))

# }}}


@dataclass(frozen=True)
class QueryInfo:
    """One archived timing fact."""

    transform_id: str
    transform_params: tuple   # frozen dict items
    runtime_in_sec: float
    compiler_version: str
    giga_op_info_json: str
    device_name: str
    _einsum: BatchedEinsum

    @cached_property
    def giga_op_info(self) -> dict:
        return load_op_info(self.giga_op_info_json)

    def giga_op_rate(self, dtype) -> float:
        return self.giga_op_info[np.dtype(dtype)] / self.runtime_in_sec

    @property
    def total_giga_op_rate(self) -> float:
        return sum(self.giga_op_info.values()) / self.runtime_in_sec

    @cached_property
    def transform(self) -> Callable:
        """The fact's transform: this package's ``tuning/impls`` module named
        by ``transform_id``, bound to the stored params (imported on first
        use)."""
        from .tuning import get_transform_func_from_module_path
        pt = get_transform_func_from_module_path(self.transform_id)
        return pt.bind_args(self._einsum, **dict(self.transform_params))


def _connect(db_path: str) -> sqlite3.Connection:
    os.makedirs(os.path.dirname(os.path.abspath(db_path)), exist_ok=True)
    conn = sqlite3.connect(db_path)
    conn.execute(f"""
        CREATE TABLE IF NOT EXISTS {TIMINGS_TABLENAME} (
            subscripts TEXT, index_to_length TEXT, args TEXT,
            arg_to_dtype TEXT, device_name TEXT, transform_id TEXT,
            transform_params TEXT, runtime_in_sec REAL,
            compiler_version TEXT, giga_op_info TEXT, timestamp TEXT
        )""")
    return conn


def retire_rows_where(cond: str, binds, *, reason: str,
                      db_path: Optional[str] = None) -> int:
    """Move the timing rows matching the SQL *cond* (with *binds*) into
    ``FEINSUM_RETIRED_FACTS``, with *reason* and the time, instead of
    deleting them; returns the number of rows moved."""
    conn = _connect(db_path or DEFAULT_DB)
    try:
        conn.execute(f"""
            CREATE TABLE IF NOT EXISTS {RETIRED_TABLENAME} AS
            SELECT *, '' AS retire_reason, '' AS retired_at
            FROM {TIMINGS_TABLENAME} WHERE 0""")
        # insert by explicit column list, growing a stash created against
        # an older timings schema to match
        cols = [r[1] for r in conn.execute(
            f"PRAGMA table_info({TIMINGS_TABLENAME})")]
        stash_cols = [r[1] for r in conn.execute(
            f"PRAGMA table_info({RETIRED_TABLENAME})")]
        for c in cols:
            if c not in stash_cols:
                conn.execute(
                    f"ALTER TABLE {RETIRED_TABLENAME} ADD COLUMN {c}")
        collist = ", ".join(cols)
        n = conn.execute(
            f"INSERT INTO {RETIRED_TABLENAME}"
            f" ({collist}, retire_reason, retired_at)"
            f" SELECT {collist}, ?, datetime('now')"
            f" FROM {TIMINGS_TABLENAME} WHERE {cond}",
            [reason] + list(binds)).rowcount
        conn.execute(f"DELETE FROM {TIMINGS_TABLENAME} WHERE {cond}",
                     list(binds))
        conn.commit()
        return n
    finally:
        conn.close()


def query(einsum: BatchedEinsum, device=None, *,
          db_path: Optional[str] = None,
          err_if_no_results: bool = True) -> list:
    """All archived facts for (canonical *einsum*, *device*), in the
    archive's row order.  A missing archive file holds no facts (and is not
    created).  A lookup is the set-up span ``feinsum.archive.query``."""
    if db_path is None:
        db_path = DEFAULT_DB
    with tracing.setup("feinsum.archive.query"):
        e = canonicalize_einsum(einsum)
        device_name = get_device_key(device)
        rows = []
        if os.path.exists(db_path):
            conn = _connect(db_path)
            try:
                rows = conn.execute(
                    f"SELECT transform_id, transform_params, runtime_in_sec,"
                    f" compiler_version, giga_op_info FROM"
                    f" {TIMINGS_TABLENAME} WHERE subscripts = ? AND"
                    f" index_to_length = ? AND args = ? AND arg_to_dtype = ?"
                    f" AND device_name = ?",
                    (e.get_subscripts(), dump_index_to_length(e),
                     dump_arg_names(e), dump_arg_to_dtype(e),
                     device_name)).fetchall()
            finally:
                conn.close()
        if not rows and err_if_no_results:
            raise NoFactInDatabaseError(
                f"No facts for '{e.get_subscripts()}' on '{device_name}' in"
                f" {db_path}")
        return [
            QueryInfo(
                transform_id=tid,
                transform_params=tuple(sorted(
                    load_transform_params(tparams).items())),
                runtime_in_sec=rt,
                compiler_version=cver,
                giga_op_info_json=ginfo,
                device_name=device_name,
                _einsum=e)
            for tid, tparams, rt, cver, ginfo in rows]


def aggregate_reconfirmations(qs: list) -> list:
    """Collapse the re-timed copies of each distinct (transform_id, params)
    configuration into one representative row: the lower-median-rate row of
    its copies timed under a current protocol (:data:`CURRENT_PROTOCOL_TAGS`)
    when any exist, else of all its copies.  A configuration with one lucky
    and one slow timing ranks by the slow one.  The rows returned are
    archive rows, sorted fastest first."""
    groups: dict = {}
    for q in qs:
        groups.setdefault((q.transform_id, q.transform_params), []).append(q)
    out = []
    for rows in groups.values():
        current = [q for q in rows
                   if any(tag in (q.compiler_version or "")
                          for tag in CURRENT_PROTOCOL_TAGS)]
        rows = sorted(current or rows, key=lambda q: q.total_giga_op_rate)
        out.append(rows[(len(rows) - 1) // 2])
    out.sort(key=lambda q: q.total_giga_op_rate, reverse=True)
    return out


def retrieve(einsum: BatchedEinsum, device=None, *,
             db_path: Optional[str] = None,
             filter_in: Optional[Callable] = None):
    """The transform of the fastest archived configuration for *einsum*
    (ranked by :func:`aggregate_reconfirmations`), optionally among the
    facts *filter_in* accepts."""
    qs = query(einsum, device, db_path=db_path)
    if filter_in is not None:
        qs = [q for q in qs if filter_in(q)]
    if not qs:
        raise NoFactInDatabaseError("all facts rejected by filter_in")
    return aggregate_reconfirmations(qs)[0].transform


def record_facts(einsum: BatchedEinsum, *, transform_id: str,
                 transform_params: dict, runtime_in_sec: Optional[float],
                 device=None, db_path: Optional[str] = None,
                 long_dim_length: int = 100_000) -> None:
    """Insert a timing fact for canonical *einsum* on *device*; with
    *runtime_in_sec* ``None`` the configuration is first validated and timed
    there (:func:`~feinsum_tpu_torch.measure.timeit`)."""
    if db_path is None:
        db_path = DEFAULT_DB
    e = canonicalize_einsum(einsum)
    if runtime_in_sec is None:
        from .measure import timeit
        from .tuning import get_transform_func_from_module_path
        pt = get_transform_func_from_module_path(transform_id)
        runtime_in_sec = timeit(e, transform=pt.bind_args(
            e, **transform_params), long_dim_length=long_dim_length,
            device=device)
    conn = _connect(db_path)
    try:
        conn.execute(
            f"INSERT INTO {TIMINGS_TABLENAME} VALUES"
            f" (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (e.get_subscripts(), dump_index_to_length(e), dump_arg_names(e),
             dump_arg_to_dtype(e), get_device_key(device), transform_id,
             json.dumps(transform_params, sort_keys=True,
                        default=_jsonify),
             float(runtime_in_sec), dump_compiler_version(),
             dump_op_info(e, long_dim_length),
             datetime.now(timezone.utc).isoformat()))
        conn.commit()
    finally:
        conn.close()


def get_timed_einsums_in_db(db_path: Optional[str] = None,
                            device=None) -> list:
    """Every distinct einsum recorded in the archive (on *device*, if
    given), rebuilt from its key columns and canonicalized; raises
    ``ValueError`` if a canonical form does not reproduce its stored key."""
    from .make_einsum import array, batched_einsum

    if db_path is None:
        db_path = DEFAULT_DB
    if not os.path.exists(db_path):
        return []
    where, params = "", ()
    if device is not None:
        where, params = " WHERE device_name = ?", (get_device_key(device),)
    conn = _connect(db_path)
    try:
        rows = conn.execute(
            f"SELECT DISTINCT subscripts, index_to_length, args,"
            f" arg_to_dtype FROM {TIMINGS_TABLENAME}{where}",
            params).fetchall()
    finally:
        conn.close()
    out = []
    for subscripts, idx_len_s, args_s, dtypes_s in rows:
        idx_len = json.loads(idx_len_s)
        dtypes = json.loads(dtypes_s)
        in_specs = [s.strip()
                    for s in subscripts.split("->")[0].split(",")]

        def length_of(ix):
            # indices absent from index_to_length are parametric
            return int(idx_len[ix]) if ix in idx_len else f"N{ix}_"

        args = [[array(name, [length_of(ix) for ix in in_specs[j]],
                       dtypes[name])
                 for j, name in enumerate(row)]
                for row in json.loads(args_s)]
        e = canonicalize_einsum(batched_einsum(subscripts, args))
        if (e.get_subscripts(), dump_index_to_length(e), dump_arg_names(e),
                dump_arg_to_dtype(e)) != (subscripts, idx_len_s, args_s,
                                          dtypes_s):
            raise ValueError(
                f"the canonical form of archived {subscripts!r} does not"
                " reproduce its key")
        out.append(e)
    return out


def apply_best_transform(einsum: BatchedEinsum, device=None, *,
                         db_path: Optional[str] = None):
    """The program of *einsum* transformed by its best archived fact
    (:func:`retrieve`)."""
    from .codegen.program import generate_program
    return retrieve(einsum, device, db_path=db_path)(
        generate_program(einsum))
