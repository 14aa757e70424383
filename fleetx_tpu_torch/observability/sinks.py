"""Pluggable metric-record emitters (copy of
``fleetx_tpu/observability/sinks.py``).

One record = one flat dict per logging window. Sinks append a line or
rewrite a textfile, so a crashed run's output stays parseable up to the
last flushed record:

- ``JsonlSink``  — one JSON object per line (``tools/metrics_report.py``
  reads it);
- ``CsvSink``    — columns fixed by the first record;
- ``PrometheusTextfileSink`` — node-exporter textfile-collector format,
  atomically rewritten per record.

``build_sinks`` writes from rank 0 only, unless ``Observability.gang``
asks every rank for its own rank-suffixed files.
Stdlib only.
"""

from __future__ import annotations

import csv
import json
import os
import sys
import tempfile
from typing import Optional

from fleetx_tpu_torch.utils.log import logger


class Sink:
    """Emitter protocol: ``emit(record)`` per window, ``close()`` at exit."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _coerce(v):
    """One JSON-safe value: numpy / torch scalars unboxed, containers
    recursed (perf decomposition records nest phase/contributor dicts),
    everything else stringified."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if hasattr(v, "item"):
        return v.item()
    if isinstance(v, dict):
        return {str(k): _coerce(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_coerce(x) for x in v]
    return str(v)


def _jsonable(record: dict) -> dict:
    """Coerce numpy / torch scalars so json/csv writers never choke."""
    return {k: _coerce(v) for k, v in record.items()}


class JsonlSink(Sink):
    """One JSON object per line, append-only, line-buffered."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)  # line-buffered: crash-safe

    def emit(self, record: dict) -> None:
        """Append one record as a JSON line."""
        self._f.write(json.dumps(_jsonable(record)) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class CsvSink(Sink):
    """Header comes from the first record; later records are projected onto
    those columns (extra keys dropped, missing keys empty)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1, newline="")
        self._writer = csv.writer(self._f)  # stdlib quoting/escaping
        self._columns: Optional[list[str]] = None
        if os.path.getsize(path):
            with open(path, newline="") as f:  # resumed run: keep the header
                head = next(csv.reader(f), None)
            if head:
                self._columns = head

    def emit(self, record: dict) -> None:
        """Append one CSV row (header fixed by the first record)."""
        record = _jsonable(record)
        if self._columns is None:
            self._columns = list(record)
            self._writer.writerow(self._columns)
        self._writer.writerow(
            ["" if record.get(c) is None else record.get(c, "")
             for c in self._columns])

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class PrometheusTextfileSink(Sink):
    """Latest-value gauges in textfile-collector format.

    Each flush rewrites the whole file via tempfile+rename (atomic on
    POSIX), the contract node-exporter's textfile collector expects.
    """

    PREFIX = "fleetx_"

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def emit(self, record: dict) -> None:
        """Atomically rewrite the textfile with the record's numbers."""
        lines = []
        for k, v in _jsonable(record).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue  # prometheus carries numbers only
            name = self.PREFIX + "".join(
                c if c.isalnum() or c == "_" else "_" for c in k)
            lines.append(f"# TYPE {name} gauge\n{name} {v}\n")
        d = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".prom.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.writelines(lines)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


def _process_index() -> int:
    """This process's rank: ``torch.distributed``'s when a group is up,
    else 0."""
    dist = getattr(sys.modules.get("torch"), "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


_SINK_TYPES = {
    "jsonl": (JsonlSink, "metrics.jsonl"),
    "csv": (CsvSink, "metrics.csv"),
    "prometheus": (PrometheusTextfileSink, "metrics.prom"),
}


def build_sinks(sink_names, output_dir: str,
                rank0_only: bool = True, suffix: str = "") -> list[Sink]:
    """Instantiate sinks under ``output_dir``; non-zero ranks get ``[]``.

    Unknown names warn and are skipped — a typo in YAML must not kill a
    multi-hour training run at its first logging window.

    ``suffix`` is inserted before the file extension (gang mode passes
    ``.rank<i>`` so every rank writes its own ``metrics.rank<i>.jsonl``
    instead of the rank-0-gated single file — the per-rank inputs
    ``tools/metrics_report.py`` merges).
    """
    if rank0_only and _process_index() != 0:
        return []
    sinks: list[Sink] = []
    for name in sink_names or []:
        entry = _SINK_TYPES.get(str(name).lower())
        if entry is None:
            logger.warning("unknown observability sink %r (known: %s)",
                           name, sorted(_SINK_TYPES))
            continue
        cls, fname = entry
        if suffix:
            root, ext = os.path.splitext(fname)
            fname = f"{root}{suffix}{ext}"
        sinks.append(cls(os.path.join(output_dir, fname)))
    return sinks
