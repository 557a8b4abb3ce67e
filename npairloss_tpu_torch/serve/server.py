"""RetrievalServer — JSONL requests in, top-k answers out.

Port of the core of ``npairloss_tpu/serve/server.py``: admit -> one
``MicroBatcher`` -> :meth:`_dispatch_core` (encode raw inputs, then one
top-k dispatch) -> answers in request order.  Tenants, replicas,
admission control, hot-swap, the ingest WAL, query tracing, shadow
scoring, HTTP and failpoints are not ported yet.

Request: ``{"id": ..., "embedding": [...]}`` or ``{"id": ..., "input":
[...]}`` (a raw NHWC image; needs a model).  Answer: ``{"id",
"neighbors": [{"rank", "row", "gallery_id", "label", "score"}, ...]}``
plus the freshness ages; a failed or rejected query answers ``{"id",
"error"}``.  The last line is a ``serve_drain`` summary whose counters
satisfy ``queries == answered + (errors - errors_refused) + rejected``:
``errors_refused`` counts lines refused before admission (bad JSON),
which are errors but never queries — ``queries_dropped`` is the
residual and must read 0.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from npairloss_tpu_torch.serve.batcher import (
    BatcherConfig,
    MicroBatcher,
    QueueFullError,
)
from npairloss_tpu_torch.serve.engine import NoModelError, QueryEngine

log = logging.getLogger("npairloss_tpu_torch.serve")


@dataclasses.dataclass(frozen=True)
class Freshness:
    """What the tier answers from and how old it is: the index's commit
    time and the model weights file's modification time."""

    index_path: Optional[str] = None
    index_created: Optional[float] = None
    weights_path: Optional[str] = None
    weights_created: Optional[float] = None

    @classmethod
    def collect(cls, index=None, index_path: Optional[str] = None,
                weights_path: Optional[str] = None) -> "Freshness":
        return cls(
            index_path=index_path,
            index_created=getattr(index, "created", None),
            weights_path=(os.path.abspath(weights_path)
                          if weights_path else None),
            weights_created=(os.path.getmtime(weights_path)
                             if weights_path else None))

    def ages(self, now: Optional[float] = None) -> Dict[str, float]:
        """``index_age_s``/``model_age_s``; a key is absent when its
        identity is unknown, never reported as fresh."""
        now = time.time() if now is None else now
        out: Dict[str, float] = {}
        if self.index_created is not None:
            out["index_age_s"] = round(max(now - self.index_created, 0.0), 3)
        if self.weights_created is not None:
            out["model_age_s"] = round(
                max(now - self.weights_created, 0.0), 3)
        return out

    def identity(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.index_path is not None:
            out["index_path"] = self.index_path
        if self.weights_path is not None:
            out["weights_path"] = self.weights_path
        return out


# Latency samples kept for the p50/p99 estimate.
LATENCY_WINDOW = 1024


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """``poll_s``: how long a ready answer may wait for the idle flush."""

    poll_s: float = 0.1


class RetrievalServer:
    """One engine behind one micro-batcher and the JSONL front end."""

    def __init__(self, engine: QueryEngine,
                 batcher_cfg: BatcherConfig = BatcherConfig(),
                 cfg: ServerConfig = ServerConfig(),
                 freshness: Optional[Freshness] = None):
        self.engine = engine
        self.cfg = cfg
        self.freshness = freshness
        self.batcher = MicroBatcher(self._dispatch_core, batcher_cfg)
        self._lat = collections.deque(maxlen=LATENCY_WINDOW)
        self._lock = threading.Lock()
        self.queries = 0  # guarded-by: _lock
        self.answered = 0  # guarded-by: _lock
        self.errors = 0  # guarded-by: _lock
        self.errors_refused = 0  # guarded-by: _lock

    # -- serving core ------------------------------------------------------

    def _dispatch_core(self, items: List[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
        """Coalesced records -> per-record answers.  A malformed record
        answers ``{"id", "error"}`` without failing its co-riders; raw
        inputs encode as one stacked batch, then join the embedding rows
        for one top-k dispatch."""
        engine = self.engine
        dim = engine.index.dim
        answers: List[Optional[Dict[str, Any]]] = [None] * len(items)
        emb_rows: List[tuple] = []
        enc_rows: List[tuple] = []
        for i, rec in enumerate(items):
            try:
                if "embedding" in rec:
                    e = np.asarray(rec["embedding"], np.float32)
                    if e.shape != (dim,):
                        raise ValueError(
                            f"embedding shape {e.shape} does not match "
                            f"gallery dim ({dim},)")
                    emb_rows.append((i, e))
                elif "input" in rec:
                    enc_rows.append((i, np.asarray(rec["input"], np.float32)))
                else:
                    raise ValueError(
                        "query record needs an 'embedding' or 'input' field")
            except (ValueError, TypeError) as e:
                answers[i] = {"id": rec.get("id"), "error": str(e)}
        if enc_rows:
            try:
                enc = engine.encode(np.stack([x for _, x in enc_rows]))
                if enc.shape[1] != dim:
                    raise ValueError(f"model embeds to {enc.shape[1]} dims, "
                                     f"the gallery holds {dim}")
                emb_rows.extend((i, row) for (i, _), row in zip(enc_rows, enc))
            except (ValueError, NoModelError) as e:
                # A ragged stack or a model-less engine fails these
                # records only; a device fault fails the whole batch.
                for i, _ in enc_rows:
                    answers[i] = {"id": items[i].get("id"), "error": str(e)}
        if emb_rows:
            out = engine.query(np.stack([x for _, x in emb_rows]))
            ages = self.freshness.ages() if self.freshness else {}
            for j, (i, _) in enumerate(emb_rows):
                answers[i] = {
                    "id": items[i].get("id"),
                    **ages,
                    "neighbors": [
                        {"rank": r,
                         "row": int(out["rows"][j, r]),
                         "gallery_id": int(out["ids"][j, r]),
                         "label": int(out["labels"][j, r]),
                         "score": round(float(out["scores"][j, r]), 6)}
                        for r in range(out["scores"].shape[1])
                    ],
                }
        return answers

    def submit(self, record: Dict[str, Any]):
        """Admit one record; returns (future, t_submit).  Raises
        :class:`QueueFullError` on backpressure (counted in rejected)."""
        with self._lock:
            self.queries += 1
        return self.batcher.submit(record), time.perf_counter()

    def _account(self, answer: Dict[str, Any], t0: float) -> Dict[str, Any]:
        with self._lock:
            if "error" in answer:
                self.errors += 1
            else:
                self.answered += 1
                self._lat.append((time.perf_counter() - t0) * 1e3)
        return answer

    # -- summary -----------------------------------------------------------

    def _percentiles(self) -> Dict[str, float]:
        lat = list(self._lat)
        if not lat:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        return {"p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99))}

    def summary(self) -> Dict[str, Any]:
        rejected = self.batcher.rejected
        return {
            "event": "serve_drain",
            "queries": self.queries,
            "answered": self.answered,
            "errors": self.errors,
            "errors_refused": self.errors_refused,
            "rejected": rejected,
            "queries_dropped": (self.queries - self.answered
                                - (self.errors - self.errors_refused)
                                - rejected),
            "batches": self.batcher.batches,
            "device": str(self.engine.device),
            **(self.freshness.identity() if self.freshness else {}),
            **(self.freshness.ages() if self.freshness else {}),
            **{k: round(v, 3) for k, v in self._percentiles().items()},
            **self.engine.stats(),
        }

    # -- stdin/JSONL front end ---------------------------------------------

    def run_jsonl(self, in_stream, out_stream) -> int:
        """Serve line-delimited JSON until EOF; answers go out in request
        order, then the drain summary.  Returns the exit code (0)."""
        self.batcher.start()
        pending: collections.deque = collections.deque()

        def emit(obj) -> None:
            out_stream.write(json.dumps(obj) + "\n")
            out_stream.flush()

        def flush_ready(block: bool) -> None:
            while pending:
                rec_id, fut, t0 = pending[0]
                if not block and not fut.done():
                    return
                try:
                    answer = self._account(fut.result(timeout=120.0), t0)
                except Exception as e:  # noqa: BLE001 — answer the failure
                    with self._lock:
                        self.errors += 1
                    answer = {"id": rec_id, "error": str(e)}
                pending.popleft()
                emit(answer)

        # A reader thread blocks in readline and feeds a queue, so answers
        # flush within poll_s while the input is idle.
        lines_q: queue.Queue = queue.Queue()
        eof_mark = object()

        def _read() -> None:
            try:
                for line in iter(in_stream.readline, ""):
                    lines_q.put(line)
            except (OSError, ValueError) as e:
                log.warning("jsonl reader: %s", e)
            finally:
                lines_q.put(eof_mark)

        threading.Thread(target=_read, daemon=True,
                         name="serve-jsonl-reader").start()
        try:
            while True:
                try:
                    line = lines_q.get(timeout=self.cfg.poll_s)
                except queue.Empty:
                    flush_ready(block=False)
                    continue
                if line is eof_mark:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    if not isinstance(rec, dict):
                        raise ValueError("a request must be a JSON object")
                except ValueError as e:
                    with self._lock:
                        self.errors += 1
                        self.errors_refused += 1
                    emit({"id": None, "error": f"bad request JSON: {e}"})
                    continue
                try:
                    fut, t0 = self.submit(rec)
                    pending.append((rec.get("id"), fut, t0))
                except QueueFullError as e:
                    emit({"id": rec.get("id"), "error": str(e)})
                flush_ready(block=False)
        finally:
            self.batcher.close(drain=True)
            flush_ready(block=True)
            s = self.summary()
            log.info("serve drain: %s", s)
            emit(s)
        return 0
