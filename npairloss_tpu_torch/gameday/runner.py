"""Gameday runner — one supervised chaos window over the composed stack.

The port of ``npairloss_tpu/gameday/runner.py``: the same scenarios,
traffic, schedules, SLO and policy tables, child command lines (with
``python -m npairloss_tpu_torch`` and, when the caller asks for the
CPU, ``--device cpu``) and exit-code contract.  The supervisor touches
only the host; its children are the port's CLI, on the card unless
``device="cpu"``.

Launches the production shape as one process group — a trainer
snapshotting continuously (``--resume auto``, the supervisor-relaunch
contract), a replicated serving tier (``--live-obs --remediate
--watch-snapshots --index-prefix --explicit-drops``, SLO admission,
shadow scoring), and the offline watch evaluator following the same
telemetry — then drives the deterministic traffic plan
(gameday/traffic.py) through it while the chaos schedule
(gameday/schedule.py) injects faults: failpoints armed via
``NPAIRLOSS_FAILPOINTS`` in each child's environment, signals delivered
at their scripted offsets (SIGTERM mid-stream relaunches the trainer;
SIGKILL cold-restarts the serving tier from its published artifacts +
WAL, the durable-ingest drill of docs/RESILIENCE.md §Durability).

At the end it collects every artifact — answers, alert logs,
remediation audits, quality windows, metric rows, the fleet report,
the drain summary — and hands them to gameday/verdict.py, writing the
``npairloss-gameday-v1`` report to ``<out>/gameday.json``.

This module runs the composed system, so unlike the verdict it may
import numpy, torch and the package freely; everything it feeds the verdict
is plain dicts/lists.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from npairloss_tpu_torch.gameday import schedule as chaos
from npairloss_tpu_torch.gameday import traffic as tg
from npairloss_tpu_torch.gameday import verdict as gv

log = logging.getLogger("npairloss_tpu_torch.gameday")

# SLO targets the run arms; the verdict judges against the SAME numbers
# (one source of truth — runner passes them through to the report).
P99_TARGET_MS = 150.0
RECALL_FLOOR = 0.9
MODEL_STALENESS_S = 6.0
INDEX_STALENESS_S = 30.0
MIN_HOT_SWAPS = 3


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)


def _child_env(failpoints_spec: str = "") -> Dict[str, str]:
    """The children's environment: this process's own (the card stays
    visible), with ``NPAIRLOSS_FAILPOINTS`` cleared and re-armed per
    target."""
    env = dict(os.environ)
    env.pop("NPAIRLOSS_FAILPOINTS", None)
    if failpoints_spec:
        env["NPAIRLOSS_FAILPOINTS"] = failpoints_spec
    return env


def _jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn tail — the writer was SIGTERMed
    return out


def _count_fires(paths: Sequence[str]) -> Dict[str, int]:
    """``failpoint fired: <name>`` occurrences across the child logs —
    the injection evidence the verdict reconciles declarations
    against."""
    fires: Dict[str, int] = {}
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                marker = "failpoint fired: "
                idx = line.find(marker)
                if idx >= 0:
                    name = line[idx + len(marker):].strip()
                    fires[name] = fires.get(name, 0) + 1
    return fires


class GamedayError(RuntimeError):
    """The run itself broke (a child died wrong, setup failed) — as
    opposed to a clean run whose verdict failed."""


class _Supervisor:
    """The process group: launch, signal, drain, never leak."""

    def __init__(self):
        self.procs: Dict[str, subprocess.Popen] = {}
        self.files: List[Any] = []

    def open(self, path: str, mode: str = "wb"):
        f = open(path, mode)
        self.files.append(f)
        return f

    def launch(self, name: str, cmd: List[str], *, env: Dict[str, str],
               stdout, stderr, stdin=None) -> subprocess.Popen:
        log.info("gameday: launching %s: %s", name, " ".join(cmd))
        proc = subprocess.Popen(cmd, env=env, stdin=stdin,
                                stdout=stdout, stderr=stderr,
                                cwd=_repo_root())
        self.procs[name] = proc
        return proc

    def cleanup(self):
        for name, proc in self.procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in self.files:
            try:
                f.close()
            except OSError:
                pass


def _python() -> List[str]:
    return [sys.executable, "-m", "npairloss_tpu_torch"]


def _device_args(device: Optional[str]) -> List[str]:
    """What the train/serve children get for ``device``: ``--device
    cpu`` when the caller asks for the CPU, else nothing (the CLI's
    default is the card).  Without a card and without ``"cpu"`` this
    raises, as every entry point of the port does — a day never
    carries on on the CPU by itself."""
    if device == "cpu":
        return ["--device", "cpu"]
    from npairloss_tpu_torch.device import resolve_device

    resolve_device(device)
    return []


def _setup_workspace(out: str, cfg: tg.TrafficConfig):
    """Gallery, initial index commit, solver config, SLO/policy
    tables.  Returns (emb, labels, solver_path)."""
    for sub in ("idx", "snap", "serve_tel", "train_tel"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
    emb = rng.standard_normal((cfg.catalog, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = (np.arange(cfg.catalog) % 16).astype(np.int32)

    from npairloss_tpu_torch.serve.index import GalleryIndex

    # Built on the host: the supervisor never touches the card.
    index = GalleryIndex.build(emb, labels, normalize=False, device="cpu")
    index.save(os.path.join(out, "idx", "g_0000.gidx"))

    solver = os.path.join(out, "solver.prototxt")
    with open(solver, "w", encoding="utf-8") as f:
        f.write(
            'net: "examples/tiny_net.prototxt"\n'
            "base_lr: 0.05\n"
            'lr_policy: "fixed"\n'
            "momentum: 0.9\n"
            "max_iter: 100000\n"
            "display: 0\n"
            "test_interval: 0\n"
            "test_iter: 0\n"
            "snapshot: 40\n"
            f'snapshot_prefix: "{out}/snap/m_"\n'
        )

    _write_json(os.path.join(out, "slo.json"), {"slos": [
        {"name": "model_staleness", "metric": "serve_model_age_s",
         "op": "<=", "target": MODEL_STALENESS_S, "window_s": 2.0,
         "burn_threshold": 0.5, "min_samples": 1,
         "severity": "warning"},
        {"name": "index_staleness", "metric": "serve_index_age_s",
         "op": "<=", "target": INDEX_STALENESS_S, "window_s": 2.0,
         "burn_threshold": 0.5, "min_samples": 1,
         "severity": "warning"},
        {"name": "serve_p99", "metric": "serve_p99_ms", "op": "<=",
         "target": P99_TARGET_MS, "window_s": 2.0,
         "burn_threshold": 0.5, "min_samples": 1,
         "severity": "critical"},
        {"name": "serve_recall_floor", "metric": "serve_recall_at_10",
         "op": ">=", "target": RECALL_FLOOR, "window_s": 2.0,
         "burn_threshold": 0.5, "min_samples": 1,
         "severity": "critical"},
    ]})
    # Generous budgets: early hot-swap attempts legitimately fail with
    # NothingNewer while the freshly-launched trainer is still
    # importing — the policy must retry past that window.
    _write_json(os.path.join(out, "rem.json"), {"policies": [
        {"name": "hotswap_model", "slo": "model_staleness",
         "action": "snapshot_hotswap", "cooldown_s": 3.0,
         "max_attempts": 10},
        {"name": "hotswap_index", "slo": "index_staleness",
         "action": "snapshot_hotswap", "cooldown_s": 3.0,
         "max_attempts": 10},
        {"name": "load_shed", "slo": "serve_p99", "action": "load_shed",
         "cooldown_s": 6.0, "max_attempts": 4},
    ]})
    _write_json(os.path.join(out, "train_slo.json"), {"slos": [
        {"name": "embedding_collapse",
         "metric": "train_an_threshold_mean", "op": "<=",
         "target": 0.98, "window_s": 2.0, "burn_threshold": 0.5,
         "min_samples": 3, "severity": "warning"},
    ]})
    _write_json(os.path.join(out, "train_rem.json"), {"policies": [
        {"name": "trainer_rollback", "slo": "embedding_collapse",
         "action": "trainer_rollback", "cooldown_s": 6.0,
         "max_attempts": 5},
    ]})
    return emb, labels, solver


def _train_cmd(solver: str, out: str,
               device: Optional[str] = None) -> List[str]:
    return _python() + [
        "train", "--solver", solver, "--model", "mlp", "--synthetic",
        "--resume", "auto", "--health-metrics",
        # Retention GC is a CLI knob, not a Caffe solver field — the
        # prototxt parser would silently drop it, and a 75s compressed
        # day at CPU step rates commits hundreds of snapshots.
        "--snapshot-keep", "10",
        "--telemetry-dir", os.path.join(out, "train_tel"),
        "--live-obs", "--slo-config", os.path.join(out, "train_slo.json"),
        "--slo-tick", "0.2", "--remediate",
        "--remediation-config", os.path.join(out, "train_rem.json"),
    ] + _device_args(device)


def _serve_cmd(out: str, replicas: int,
               device: Optional[str] = None) -> List[str]:
    return _python() + [
        "serve", "--index-prefix", os.path.join(out, "idx", "g_"),
        "--snapshot", os.path.join(out, "boot", "m_iter_40.ckpt"),
        "--model", "mlp", "--input-size", "8",
        "--watch-snapshots", os.path.join(out, "snap", "m_"),
        "--compile-cache", os.path.join(out, "xla_cache"),
        "--top-k", "10", "--buckets", "1", "--deadline-ms", "1",
        "--max-queue", "64", "--replicas", str(replicas),
        "--admission", "slo", "--admission-slos", "serve_p99",
        "--explicit-drops", "--metrics-window", "4",
        "--shadow-rate", "1", "--shadow-window", "4",
        "--telemetry-dir", os.path.join(out, "serve_tel"),
        "--live-obs", "--slo-config", os.path.join(out, "slo.json"),
        "--slo-tick", "0.2", "--remediate",
        "--remediation-config", os.path.join(out, "rem.json"),
        # Per-query tracing: the p99-attribution verdict check reads
        # the qtrace_dominant window rows and the qtrace.json reroute
        # counters this arms (docs/OBSERVABILITY.md §Query tracing).
        "--qtrace", "--qtrace-slo-ms", str(P99_TARGET_MS),
        # Durable ingest (docs/RESILIENCE.md §Durability): the gallery
        # growth stream rides stdin through the WAL, and the SIGKILL
        # drill's cold restart recovers from this directory + the
        # published checkpoints alone.  Checkpoints land under the
        # same watched prefix, so hot-swap feeds on them too.
        "--wal-dir", os.path.join(out, "wal"),
        "--wal-flush-ms", "2", "--wal-checkpoint-every", "4",
    ] + _device_args(device)


def _send(io: Dict[str, Any], line: bytes,
          deadline_s: float = 20.0) -> bool:
    """Write one line to the serve stdin currently installed in ``io``
    — shared by the feeder and the ingester, so the lock also keeps
    their lines whole.  A broken pipe means the tier was SIGKILLed;
    retry against whatever stdin the supervisor installs at relaunch
    (the host-crash drill's client-side contract: the stream resumes,
    it does not abort).  False when the gap outlives the deadline."""
    t_end = time.monotonic() + deadline_s
    while True:
        try:
            with io["lock"]:
                stdin = io["stdin"]
                stdin.write(line)
                stdin.flush()
            return True
        except (BrokenPipeError, ValueError, OSError):
            if time.monotonic() >= t_end:
                return False
            time.sleep(0.2)


def _feed(plan: tg.TrafficPlan, emb: np.ndarray, io: Dict[str, Any],
          t0: float, state: Dict[str, Any],
          tenant_embs: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Pace the plan's query events against the monotonic clock and
    write them to the tier's stdin.  Writes may block on pipe
    backpressure while the tier warms or degrades — that only delays
    later events, it never reorders or drops them.  Multi-tenant plans
    stamp each record with its tenant and draw the query vector from
    THAT tenant's gallery (``tenant_embs``); tenantless plans keep the
    pre-tenant line shape byte for byte."""
    for ev in plan.queries:
        wait = (t0 + ev.t) - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        src = (emb if ev.tenant is None
               else (tenant_embs or {})[ev.tenant])
        req = {"id": ev.qid,
               "embedding": src[ev.key % src.shape[0]].tolist()}
        if ev.tenant is not None:
            req["tenant"] = ev.tenant
        line = json.dumps(req)
        if not _send(io, line.encode("utf-8") + b"\n"):
            state["feed_error"] = f"serve stdin broke at qid {ev.qid}"
            return
        state["fed"] = state.get("fed", 0) + 1


def _ingest(plan: tg.TrafficPlan, emb: np.ndarray,
            labels: np.ndarray, io: Dict[str, Any], t0: float,
            state: Dict[str, Any]) -> None:
    """The gallery-growth stream, riding the DURABLE ingest path: each
    scripted event becomes a stdin ingest record the tier must
    WAL-append + fsync before acking; the vectors reach the served
    index via published checkpoints + hot-swap (the remediation's food
    supply, same as the old out-of-band commits).  Every batch sent is
    kept in ``state["ingest_sent"]`` — the oracle the host-crash
    verdict replays the final artifacts against."""
    cfg = plan.cfg
    rng = np.random.default_rng(cfg.seed + 1)
    dim = emb.shape[1]
    for ev in plan.ingest:
        wait = (t0 + ev.t) - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        new = rng.standard_normal((ev.rows, dim)).astype(np.float32)
        new /= np.linalg.norm(new, axis=1, keepdims=True)
        new_labels = (np.arange(ev.rows) % 16).astype(np.int32)
        # Ids far above the catalog range, strided so batches can
        # never collide — replay determinism needs the CLIENT to own
        # identity (the WAL forbids auto-assignment).
        ids = [10_000_000 + ev.commit_id * 10_000 + j
               for j in range(ev.rows)]
        rid = f"ing-{ev.commit_id}"
        line = json.dumps({"id": rid, "ingest": {
            "ids": ids, "labels": new_labels.tolist(),
            "embeddings": new.tolist()}})
        if not _send(io, line.encode("utf-8") + b"\n"):
            state["ingest_error"] = f"serve stdin broke at {rid}"
            return
        state.setdefault("ingest_sent", {})[rid] = {"ids": ids,
                                                    "emb": new}
        state["ingest_commits"] = state.get("ingest_commits", 0) + 1


def run_gameday(out: str, *, seed: int = 0, duration_s: float = 75.0,
                schedule_path: Optional[str] = None,
                replicas: int = 2,
                device: Optional[str] = None) -> Dict[str, Any]:
    """The whole gameday: setup, launch, drive, drain, verdict.
    Returns the ``npairloss-gameday-v1`` report (also written to
    ``<out>/gameday.json``).  ``device``: None runs the children on
    the card (and raises without one); ``"cpu"`` on the CPU."""
    dev_args = _device_args(device)
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    entries = (chaos.load_schedule(schedule_path) if schedule_path
               else chaos.default_schedule(duration_s))
    cfg = tg.TrafficConfig(seed=seed, duration_s=duration_s,
                           base_qps=6.0, peak_qps=14.0, burst_qps=45.0,
                           bursts=2, burst_s=3.0, catalog=256,
                           zipf_s=1.1, ingest_every_s=10.0,
                           ingest_rows=16)
    plan = tg.generate(cfg)
    with open(os.path.join(out, "traffic.jsonl"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(tg.plan_lines(plan)) + "\n")
    emb, labels, solver = _setup_workspace(out, cfg)

    sup = _Supervisor()
    state: Dict[str, Any] = {"fed": 0}
    trainer_exits: List[int] = []
    try:
        # Phase 0: one short run commits the INITIAL snapshot the
        # server restores (and the freshness clock starts from).
        seed_log = os.path.join(out, "seed.log")
        with open(seed_log, "wb") as f:
            rc = subprocess.call(
                _python() + ["train", "--solver", solver, "--model",
                             "mlp", "--synthetic", "--max_iter", "40"]
                + dev_args,
                env=_child_env(), stdout=f, stderr=subprocess.STDOUT,
                cwd=_repo_root())
        seed_snap = os.path.join(out, "snap", "m_iter_40.ckpt",
                                 "manifest.json")
        if rc != 0 or not os.path.exists(seed_snap):
            raise GamedayError(
                f"seed training failed (rc={rc}); see {seed_log}")
        # The chaos trainer's retention GC (--snapshot-keep) will delete
        # m_iter_40 within seconds at CPU step rates — copy it outside
        # the GC'd prefix so the server's initial --snapshot load can
        # never race the deletion.
        boot_snap = os.path.join(out, "boot", "m_iter_40.ckpt")
        shutil.copytree(os.path.dirname(seed_snap), boot_snap)

        # Launch the group: trainer (chaos-armed), serving tier
        # (chaos-armed), watch evaluator.
        trainer = sup.launch(
            "train", _train_cmd(solver, out, device),
            env=_child_env(chaos.env_spec(entries, "train")),
            stdout=sup.open(os.path.join(out, "train1.log")),
            stderr=subprocess.STDOUT)
        serve = sup.launch(
            "serve", _serve_cmd(out, replicas, device),
            env=_child_env(chaos.env_spec(entries, "serve")),
            stdin=subprocess.PIPE,
            stdout=sup.open(os.path.join(out, "answers.jsonl")),
            stderr=sup.open(os.path.join(out, "serve.log")))
        t0 = time.monotonic()
        io: Dict[str, Any] = {"stdin": serve.stdin,
                              "lock": threading.Lock()}

        feeder = threading.Thread(
            target=_feed, args=(plan, emb, io, t0, state),
            name="gameday-feed", daemon=True)
        feeder.start()
        ingester = threading.Thread(
            target=_ingest, args=(plan, emb, labels, io, t0, state),
            name="gameday-ingest", daemon=True)
        ingester.start()

        # Watch follows the serve telemetry once it exists.
        serve_metrics = os.path.join(out, "serve_tel", "metrics.jsonl")
        watch = None
        observed_signals: Dict[str, int] = {}
        sigs = chaos.signals(entries, "train")
        serve_sigs = chaos.signals(entries, "serve")
        while time.monotonic() - t0 < duration_s:
            now = time.monotonic() - t0
            if watch is None and os.path.exists(serve_metrics):
                watch = sup.launch(
                    "watch",
                    _python() + ["watch", os.path.join(out, "serve_tel"),
                                 "--slo-config",
                                 os.path.join(out, "slo.json"),
                                 "--follow", "--poll-s", "0.5",
                                 "--for", str(duration_s + 30.0)],
                    env=_child_env(),
                    stdout=sup.open(os.path.join(out, "watch.log")),
                    stderr=subprocess.STDOUT)
            if sigs and now >= sigs[0].at_s:
                entry = sigs.pop(0)
                signum = getattr(signal, entry.name, signal.SIGTERM)
                log.info("gameday: delivering %s to trainer at %.1fs",
                         entry.name, now)
                trainer.send_signal(signum)
                rc = trainer.wait(timeout=60)
                trainer_exits.append(rc)
                observed_signals[entry.name] = (
                    observed_signals.get(entry.name, 0) + 1)
                if rc != 75:
                    raise GamedayError(
                        f"trainer {entry.name} expected exit 75, "
                        f"got {rc}; see {out}/train1.log")
                # Relaunch the SAME command — the auto-resume
                # contract; the consumed chaos env is NOT re-armed.
                trainer = sup.launch(
                    "train", _train_cmd(solver, out, device),
                    env=_child_env(),
                    stdout=sup.open(os.path.join(out, "train2.log")),
                    stderr=subprocess.STDOUT)
            if serve_sigs and now >= serve_sigs[0].at_s:
                entry = serve_sigs.pop(0)
                signum = getattr(signal, entry.name, signal.SIGKILL)
                log.info("gameday: delivering %s to serve at %.1fs",
                         entry.name, now)
                serve.send_signal(signum)
                serve.wait(timeout=60)
                observed_signals[entry.name] = (
                    observed_signals.get(entry.name, 0) + 1)
                state.setdefault("kill_walls", []).append(time.time())
                # A SIGKILL ran no handler: no drain, no final qtrace
                # write.  Preserve the periodically-checkpointed
                # artifact before the relaunched tier overwrites it —
                # reconcile merges its marker totals back in.
                qt = os.path.join(out, "serve_tel", "qtrace.json")
                if os.path.exists(qt):
                    os.replace(qt, os.path.join(
                        out, "serve_tel",
                        f"qtrace.pre{len(state['kill_walls'])}.json"))
                # Cold restart from the published artifacts + WAL
                # alone — same command, consumed chaos NOT re-armed;
                # answers APPEND so the dead tier's acks stay evidence.
                serve = sup.launch(
                    "serve", _serve_cmd(out, replicas, device),
                    env=_child_env(),
                    stdin=subprocess.PIPE,
                    stdout=sup.open(
                        os.path.join(out, "answers.jsonl"), "ab"),
                    stderr=sup.open(
                        os.path.join(out, "serve2.log"), "ab"))
                with io["lock"]:
                    old_stdin, io["stdin"] = io["stdin"], serve.stdin
                try:
                    old_stdin.close()
                except OSError:
                    pass
            if serve.poll() is not None:
                raise GamedayError(
                    f"serve died mid-window (rc={serve.returncode}); "
                    f"see {out}/serve.log")
            if trainer.poll() is not None:
                raise GamedayError(
                    f"trainer died mid-window (rc={trainer.returncode})"
                    f"; see {out}/train1.log")
            time.sleep(0.25)

        feeder.join(timeout=30.0)
        time.sleep(3.0)  # let the last swap's resolution land

        # Drain: SIGTERM first (rc 75, the preemption contract), then
        # EOF on stdin so the reader unblocks.
        serve.send_signal(signal.SIGTERM)
        time.sleep(0.2)
        serve.stdin.close()
        serve_rc = serve.wait(timeout=120)
        if serve_rc != 75:
            raise GamedayError(
                f"serve drain expected exit 75, got {serve_rc}; "
                f"see {out}/serve.log")
        trainer.send_signal(signal.SIGTERM)
        rc = trainer.wait(timeout=60)
        trainer_exits.append(rc)
        if rc != 75:
            raise GamedayError(
                f"trainer drain expected exit 75, got {rc}; "
                f"see {out}/train2.log")
        if watch is not None:
            try:
                watch.wait(timeout=45)
            except subprocess.TimeoutExpired:
                watch.terminate()
                watch.wait(timeout=15)
        ingester.join(timeout=15.0)
    finally:
        sup.cleanup()

    if state.get("feed_error"):
        raise GamedayError(state["feed_error"])
    if state.get("ingest_error"):
        raise GamedayError(f"ingest failed: {state['ingest_error']}")

    return _reconcile(out, entries, plan, state, trainer_exits,
                      observed_signals, duration_s=duration_s,
                      seed=seed)


def _host_crash_evidence(out: str, answers: List[Dict[str, Any]],
                         state: Dict[str, Any],
                         drain: Dict[str, Any]) -> Dict[str, Any]:
    """The durable-ingest oracle: replay every ACKED ingest batch
    against the artifacts the cold restart actually published.  The
    ingester kept each batch's ids + vectors in memory; an ack in
    answers.jsonl means the tier claimed durability BEFORE the
    SIGKILL — so every acked id must be in the final index exactly
    once, and every acked vector must retrieve ITSELF from it
    (recall parity after replay, recomputed, not trusted)."""
    kills = state.get("kill_walls") or []
    if not kills:
        return {"available": False,
                "reason": "no serve SIGKILL delivered"}
    sent = state.get("ingest_sent") or {}
    acked: Dict[str, Dict[str, Any]] = {}
    for a in answers:
        rid = a.get("id")
        if (rid in sent and isinstance(a.get("ingested"), int)
                and a["ingested"] > 0):
            acked[rid] = sent[rid]
    from npairloss_tpu_torch.serve.index import load_newest

    found = load_newest(os.path.join(out, "idx", "g_"), device="cpu")
    if found is None:
        return {"available": False,
                "reason": "no loadable index commit"}
    final_path, final = found
    final_ids = np.asarray(final.ids).astype(np.int64)
    id_set = set(int(i) for i in final_ids.tolist())
    lost = acked_vectors = 0
    hits = total = 0
    final_emb = np.asarray(final.host_emb, dtype=np.float32)
    for rid, batch in acked.items():
        ids = batch["ids"]
        acked_vectors += len(ids)
        lost += sum(1 for i in ids if int(i) not in id_set)
        top = np.argmax(batch["emb"] @ final_emb.T, axis=1)
        hits += int(np.sum(final_ids[top]
                           == np.asarray(ids, dtype=np.int64)))
        total += len(ids)
    wal_stats = (drain.get("ingest") or {}).get("wal") or {}
    return {
        "available": True,
        "kills": len(kills),
        "acked_batches": len(acked),
        "acked_vectors": int(acked_vectors),
        "lost": int(lost),
        "duplicates": int(final_ids.shape[0] - len(id_set)),
        "torn_records": int(wal_stats.get("torn_records", 0)),
        "self_recall": round(hits / total, 4) if total else 0.0,
        "final_index": os.path.basename(final_path),
    }


def _reconcile(out: str, entries, plan: tg.TrafficPlan,
               state: Dict[str, Any], trainer_exits: List[int],
               observed_signals: Dict[str, int], *,
               duration_s: float, seed: int) -> Dict[str, Any]:
    """Load every artifact and build the verdict."""
    answers = _jsonl(os.path.join(out, "answers.jsonl"))
    drains = [a for a in answers if a.get("event") == "serve_drain"]
    if not drains:
        raise GamedayError("no serve_drain summary in answers.jsonl")
    drain = drains[-1]

    serve_tel = os.path.join(out, "serve_tel")
    train_tel = os.path.join(out, "train_tel")
    serve_alerts = _jsonl(os.path.join(serve_tel, "alerts.jsonl"))
    train_alerts = _jsonl(os.path.join(train_tel, "alerts.jsonl"))
    serve_rem = _jsonl(os.path.join(serve_tel, "remediation.jsonl"))
    train_rem = _jsonl(os.path.join(train_tel, "remediation.jsonl"))
    serve_rows = [r for r in _jsonl(os.path.join(serve_tel,
                                                 "metrics.jsonl"))
                  if "p99_ms" in r and "wall_time" in r]
    quality = [r for r in _jsonl(os.path.join(serve_tel,
                                              "quality.jsonl"))
               if r.get("kind") == "window"]

    # Synthetic incident per SIGKILL: no in-process pager can observe
    # its own SIGKILL, so the RUNNER contributes the alert pair that
    # excuses the restart's SLO turbulence — firing at the kill wall,
    # resolved at the first metric window the reborn tier published
    # (the backlog it inherits lands inside the padded window).
    for i, t_kill in enumerate(state.get("kill_walls") or []):
        after = sorted(float(r["wall_time"]) for r in serve_rows
                       if float(r.get("wall_time", 0.0)) >= t_kill)
        t_rec = after[0] if after else t_kill + 30.0
        serve_alerts.append({"state": "firing",
                             "alert_id": f"host_crash_{i}",
                             "slo": "host_crash", "fired_at": t_kill})
        serve_alerts.append({"state": "resolved",
                             "alert_id": f"host_crash_{i}",
                             "slo": "host_crash", "ts": t_rec})

    # Qtrace evidence for the p99-attribution check: totals (reroute /
    # hot-swap markers) + the rolling budget decomposition.  A missing
    # or torn artifact is a reportable fact — the stage-declaring
    # faults will fail their attribution gate, which is the point.
    qtrace_block: Dict[str, Any] = {"available": False}
    try:
        with open(os.path.join(serve_tel, "qtrace.json"), "r",
                  encoding="utf-8") as f:
            qt = json.load(f)
        if isinstance(qt, dict) and isinstance(qt.get("totals"), dict):
            qtrace_block = {"available": True,
                            "totals": qt["totals"],
                            "budget": qt.get("budget", {}),
                            "slo_ms": qt.get("slo_ms")}
    except (OSError, ValueError) as e:
        qtrace_block = {"available": False, "reason": str(e)}
    # Marker totals from SIGKILLed instances: their periodically
    # checkpointed artifacts were preserved as qtrace.preN.json before
    # the relaunch overwrote the live one — a reroute counted by a
    # tier that later died is still injection evidence.
    for name in sorted(os.listdir(serve_tel)):
        if not (name.startswith("qtrace.pre") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(serve_tel, name), "r",
                      encoding="utf-8") as f:
                pre = json.load(f)
        except (OSError, ValueError):
            continue
        totals = (pre.get("totals") if isinstance(pre, dict)
                  else None)
        if not isinstance(totals, dict):
            continue
        if not qtrace_block.get("available"):
            qtrace_block = {"available": True, "totals": {},
                            "budget": pre.get("budget", {}),
                            "slo_ms": pre.get("slo_ms")}
        merged = qtrace_block.setdefault("totals", {})
        for key, val in totals.items():
            if isinstance(val, int) and not isinstance(val, bool):
                merged[key] = int(merged.get(key, 0)) + val

    from npairloss_tpu_torch.obs.fleet.aggregate import build_fleet_report

    try:
        fleet = build_fleet_report(train_tel)
        comms = fleet.get("comms", {"available": False})
    except Exception as e:  # noqa: BLE001 — a missing fleet report is
        # a reportable fact, not a crash
        comms = {"available": False, "reason": f"fleet report: {e}"}

    fires = _count_fires([os.path.join(out, name) for name in
                          ("serve.log", "serve2.log", "train1.log",
                           "train2.log")])
    for name, count in observed_signals.items():
        fires[name] = fires.get(name, 0) + count

    train2 = os.path.join(out, "train2.log")
    resumed = False
    if os.path.exists(train2):
        with open(train2, "r", encoding="utf-8",
                  errors="replace") as f:
            resumed = "resuming from iteration" in f.read()

    host_crash = _host_crash_evidence(out, answers, state, drain)

    report = gv.build_gameday_report(
        chaos.entry_dicts(entries),
        traffic={
            "planned": len(plan.queries),
            "fed": state.get("fed", 0),
            "answered": drain.get("answered"),
            "errors": drain.get("errors"),
            "rejected": drain.get("rejected"),
            "sha256": tg.plan_digest(plan),
        },
        serve_alerts=serve_alerts, train_alerts=train_alerts,
        serve_remediation=serve_rem, train_remediation=train_rem,
        serve_rows=serve_rows, quality_windows=quality,
        drain=drain, comms=comms,
        trainer={"segments": len(trainer_exits),
                 "exit_codes": trainer_exits, "resumed": resumed},
        observed_fires=fires,
        client_errors=int(drain.get("errors", 0)),
        window_s=duration_s, seed=seed,
        p99_target_ms=P99_TARGET_MS, recall_floor=RECALL_FLOOR,
        min_hot_swaps=MIN_HOT_SWAPS, qtrace=qtrace_block,
        host_crash=host_crash,
    )
    _write_json(os.path.join(out, "gameday.json"), report)
    try:
        # One Perfetto file for the whole day: trainer rank lanes,
        # serve spans + exemplar query trees, chaos/alert/remediation
        # instants (obs/fleet/merge_traces.py).  Evidence, not a gate —
        # a failed merge is logged, never fatal.
        from npairloss_tpu_torch.obs.fleet.merge_traces import (
            merge_timeline,
        )

        tl_path, _ = merge_timeline(out)
        if tl_path:
            log.info("gameday: merged timeline at %s", tl_path)
    except Exception as e:  # noqa: BLE001 — the timeline is evidence
        log.error("gameday: timeline merge failed: %s", e)
    log.info("gameday: verdict=%s (%d fault(s), %d hot-swap(s), "
             "%d/%d answered)",
             report["verdict"], len(report["faults"]),
             report["zero_drop"]["hot_swaps"],
             drain.get("answered", 0), state.get("fed", 0))
    return report


# -- tenant_skew scenario ----------------------------------------------------

TENANT_IDS = ("acme", "bcorp", "ccorp")
# The hot tenant's quota: above its steady share of the diurnal peak
# (no shedding on a quiet day) and far below its burst arrival rate
# (the burst MUST shed).  burst_s=1 keeps the token bucket shallow so
# the quota alert's evidence is unambiguous.
HOT_QUOTA_QPS = 6.0


def _tenant_workspace(out: str, cfg: tg.TrafficConfig,
                      hot_tenant: str) -> Dict[str, np.ndarray]:
    """Per-tenant galleries — SAME geometry on purpose, so the shared
    ProgramCache proves tenant count never multiplies compiles — plus
    the ``npairloss-tenants-v1`` manifest: the hot tenant gets the
    quota the burst must exhaust, every neighbor gets the p99/recall
    SLOs whose survival the verdict gates."""
    for sub in ("idx", "serve_tel"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    from npairloss_tpu_torch.serve.index import GalleryIndex
    from npairloss_tpu_torch.serve.tenants import TENANTS_SCHEMA

    embs: Dict[str, np.ndarray] = {}
    tenants: List[Dict[str, Any]] = []
    for i, tid in enumerate(TENANT_IDS):
        rng = np.random.default_rng(cfg.seed + 101 + i)
        emb = rng.standard_normal((cfg.catalog, 64)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        labels = (np.arange(cfg.catalog) % 16).astype(np.int32)
        index = GalleryIndex.build(emb, labels, normalize=False,
                                   device="cpu")
        index.save(os.path.join(out, "idx", f"{tid}-0000.gidx"))
        embs[tid] = emb
        spec: Dict[str, Any] = {
            "tenant_id": tid,
            "index_prefix": os.path.join(out, "idx", f"{tid}-"),
        }
        if tid == hot_tenant:
            spec.update(quota_qps=HOT_QUOTA_QPS, quota_burst_s=1.0)
        else:
            spec.update(p99_ms=P99_TARGET_MS, recall_floor=RECALL_FLOOR,
                        recall_k=10)
        tenants.append(spec)
    _write_json(os.path.join(out, "tenants.json"),
                {"schema": TENANTS_SCHEMA, "tenants": tenants})
    return embs


def _tenant_serve_cmd(out: str, replicas: int,
                      device: Optional[str] = None) -> List[str]:
    return _python() + [
        "serve", "--tenant-config", os.path.join(out, "tenants.json"),
        "--compile-cache", os.path.join(out, "xla_cache"),
        "--top-k", "10", "--buckets", "1", "--deadline-ms", "2",
        "--poll-s", "0.02",
        "--max-queue", "64", "--replicas", str(replicas),
        "--explicit-drops", "--metrics-window", "4",
        "--shadow-rate", "1", "--shadow-window", "4",
        "--telemetry-dir", os.path.join(out, "serve_tel"),
        "--live-obs", "--slo-tick", "0.2",
    ] + _device_args(device)


_SERVE_READY_MARKER = "shadow scoring armed"


def _wait_serve_ready(log_path: str, proc,
                      timeout_s: float = 180.0) -> None:
    """Block until the serve log shows the post-warmup marker (the
    shadow-scorer arming line is the last thing cmd_serve logs before
    entering the stdin loop).  Feeding a still-importing server piles
    the whole early schedule into the pipe; the catch-up replay then
    pollutes the first latency windows with a flood the plan never
    scripted."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if proc.poll() is not None:
            raise GamedayError(
                f"serve died during startup (rc={proc.returncode}); "
                f"see {log_path}")
        try:
            with open(log_path, "r", encoding="utf-8",
                      errors="replace") as f:
                if _SERVE_READY_MARKER in f.read():
                    return
        except OSError:
            pass
        time.sleep(0.2)
    raise GamedayError(
        f"serve not ready after {timeout_s:.0f}s (no "
        f"{_SERVE_READY_MARKER!r} in {log_path})")


def run_tenant_skew(out: str, *, seed: int = 0,
                    duration_s: float = 75.0,
                    replicas: int = 2,
                    hot_tenant: str = "acme",
                    device: Optional[str] = None) -> Dict[str, Any]:
    """The noisy-neighbor gameday (docs/SERVING.md §Multi-tenant): ONE
    serving tier, three tenant galleries, and a traffic plan whose
    single mid-window burst lands ~8x of its load on ``hot_tenant``.
    The scripted chaos is the plan itself (schedule kind "traffic") —
    the verdict must see the hot tenant quota-shed AND paged by its
    tenant-scoped alert, which must also RESOLVE before drain, while
    every other tenant kept zero errors/rejects, its whole-run p99
    under the target, and its shadow recall over the floor.

    Timing is load-bearing: the quota SLO's 30s rolling window means
    the burst's bad samples age out ~30s after the burst ends, so the
    window needs the burst mid-run with a >=30s quiet tail for the
    alert pair to complete (one burst at duration/2 with
    duration_s >= ~65).  ``device`` as :func:`run_gameday`'s."""
    _device_args(device)
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    if hot_tenant not in TENANT_IDS:
        raise GamedayError(
            f"hot_tenant must be one of {TENANT_IDS}, got {hot_tenant!r}")
    entries = chaos.tenant_skew_schedule(hot_tenant, duration_s)
    cfg = tg.TrafficConfig(
        seed=seed, duration_s=duration_s, base_qps=4.0, peak_qps=8.0,
        burst_qps=40.0, bursts=1, burst_s=6.0, catalog=256, zipf_s=1.1,
        tenants=tuple((tid, 1.0) for tid in TENANT_IDS),
        hot_tenant=hot_tenant, hot_burst_factor=8.0)
    plan = tg.generate(cfg)
    with open(os.path.join(out, "traffic.jsonl"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(tg.plan_lines(plan)) + "\n")
    embs = _tenant_workspace(out, cfg, hot_tenant)

    sup = _Supervisor()
    state: Dict[str, Any] = {"fed": 0}
    try:
        serve = sup.launch(
            "serve", _tenant_serve_cmd(out, replicas, device),
            env=_child_env(), stdin=subprocess.PIPE,
            stdout=sup.open(os.path.join(out, "answers.jsonl")),
            stderr=sup.open(os.path.join(out, "serve.log")))
        _wait_serve_ready(os.path.join(out, "serve.log"), serve)
        t0 = time.monotonic()
        io: Dict[str, Any] = {"stdin": serve.stdin,
                              "lock": threading.Lock()}
        feeder = threading.Thread(
            target=_feed, args=(plan, embs[hot_tenant], io, t0, state),
            kwargs={"tenant_embs": embs},
            name="gameday-feed", daemon=True)
        feeder.start()
        while time.monotonic() - t0 < duration_s:
            if serve.poll() is not None:
                raise GamedayError(
                    f"serve died mid-window (rc={serve.returncode}); "
                    f"see {out}/serve.log")
            time.sleep(0.25)
        feeder.join(timeout=30.0)
        # The quota alert resolves ~30s after the burst's bad samples
        # start aging out — the drain must not beat the resolution.
        time.sleep(3.0)
        serve.send_signal(signal.SIGTERM)
        time.sleep(0.2)
        serve.stdin.close()
        serve_rc = serve.wait(timeout=120)
        if serve_rc != 75:
            raise GamedayError(
                f"serve drain expected exit 75, got {serve_rc}; "
                f"see {out}/serve.log")
    finally:
        sup.cleanup()
    if state.get("feed_error"):
        raise GamedayError(state["feed_error"])

    answers = _jsonl(os.path.join(out, "answers.jsonl"))
    drains = [a for a in answers if a.get("event") == "serve_drain"]
    if not drains:
        raise GamedayError("no serve_drain summary in answers.jsonl")
    drain = drains[-1]
    serve_tel = os.path.join(out, "serve_tel")
    serve_alerts = _jsonl(os.path.join(serve_tel, "alerts.jsonl"))
    # The tier-wide p99 gate judges the AGGREGATE window rows only; a
    # tenant-stamped row is that tenant's own evidence and already
    # gated per-tenant (counting it twice would let one tenant's
    # in-quota latency fail the tier).
    serve_rows = [r for r in _jsonl(os.path.join(serve_tel,
                                                 "metrics.jsonl"))
                  if "p99_ms" in r and "wall_time" in r
                  and "tenant" not in r]
    tenant_quality = {
        tid: [r for r in _jsonl(os.path.join(serve_tel,
                                             f"quality.{tid}.jsonl"))
              if r.get("kind") == "window"]
        for tid in TENANT_IDS}

    report = gv.build_gameday_report(
        chaos.entry_dicts(entries),
        traffic={
            "planned": len(plan.queries),
            "fed": state.get("fed", 0),
            "answered": drain.get("answered"),
            "errors": drain.get("errors"),
            "rejected": drain.get("rejected"),
            "sha256": tg.plan_digest(plan),
        },
        serve_alerts=serve_alerts, train_alerts=[],
        serve_remediation=_jsonl(
            os.path.join(serve_tel, "remediation.jsonl")),
        train_remediation=[],
        serve_rows=serve_rows,
        quality_windows=[],  # recall is judged per tenant below
        drain=drain,
        comms={"available": False,
               "reason": "no trainer in the tenant_skew scenario"},
        trainer={"segments": 0, "exit_codes": [], "resumed": False},
        observed_fires={},
        client_errors=int(drain.get("errors", 0)),
        window_s=duration_s, seed=seed,
        p99_target_ms=P99_TARGET_MS, recall_floor=RECALL_FLOOR,
        # The burst is traffic, not a failpoint — there is no stall to
        # pad around, so tight pads keep real pre-burst evidence
        # outside the incident window (recall_worst must be a number,
        # not None-because-everything-was-excused).
        pad_before_s=5.0, pad_after_s=5.0,
        min_hot_swaps=0,
        tenant_hot=hot_tenant, tenant_quality=tenant_quality,
    )
    _write_json(os.path.join(out, "gameday.json"), report)
    tb = report.get("tenants") or {}
    log.info("gameday[tenant_skew]: verdict=%s (hot=%s shed+rejected=%s"
             " alerted=%s)",
             report["verdict"], hot_tenant,
             (tb.get("tenants", {}).get(hot_tenant) or {}).get(
                 "rejected"),
             (tb.get("tenants", {}).get(hot_tenant) or {}).get(
                 "alerted"))
    return report
