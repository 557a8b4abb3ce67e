"""``serve/admission.py`` and the server's admission gate in the port,
held against the JAX package on the CPU.

  * ``AdmissionController`` under the same SLO status streams (scripted,
    and from each package's own ``LiveObservatory`` over the same rows)
    gives the same admit/shed decisions, the same counters and the same
    ``serve_shedding``/``serve_shed``/``serve_probe_admitted`` series;
  * the forced shed (``engage``/``release``, the ``load_shed`` action)
    and the probe trickle decide as JAX's;
  * a tiny server of each package, built from one gallery, refuses the
    same queries while shedding, counts them in ``rejected`` (the drain
    invariant holds), and carries the same ``shed`` in its window rows,
    summary and ``/healthz``;
  * ``serve --admission slo`` wires the burn listener, and a
    ``load_shed`` remediation engages and releases the forced-only
    controller on the alert's lifecycle.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest

from npairloss_tpu.obs.live import registry as jreg
from npairloss_tpu.obs.live import slo as jslo
from npairloss_tpu.serve import admission as J
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.obs.live import registry as preg
from npairloss_tpu_torch.obs.live import slo as pslo
from npairloss_tpu_torch.serve import admission as P


def _statuses(slo_mod, burning):
    """One tick's committed statuses: ``burning`` maps SLO name -> bool."""
    return [slo_mod.SLOStatus(
        spec=slo_mod.SLOSpec(name=name, metric="m", op="<=", target=1.0),
        burning=flag, bad_fraction=1.0 if flag else 0.0, samples=1)
        for name, flag in burning.items()]


# (tick's burning flags, queries submitted after the tick); the SLO
# "other" is never watched.
STREAM = [
    ({"serve_p99": False, "serve_queue_saturation": False}, 3),
    ({"serve_p99": True, "serve_queue_saturation": False}, 10),
    ({"serve_p99": True, "serve_queue_saturation": True}, 5),
    ({"serve_p99": False, "serve_queue_saturation": True}, 9),
    ({"serve_p99": False, "serve_queue_saturation": False,
      "other": True}, 4),
    ({"serve_p99": True}, 17),
    ({"serve_p99": False}, 2),
]


def _drive(mod, slo_mod, reg_mod, slos, probe_every):
    reg = reg_mod.MetricRegistry()
    ctl = mod.controller_from_args(slos, registry=reg,
                                   probe_every=probe_every)
    out = []
    for burning, n in STREAM:
        ctl.on_statuses(_statuses(slo_mod, burning))
        out.append(([ctl.admit() for _ in range(n)], ctl.stats(),
                    reg.snapshot()))
    return out


@pytest.mark.parametrize("slos,probe_every", [
    (None, 8), ("serve_p99", 3), ("serve_queue_saturation, other", 2),
    (",", 0),
])
def test_controller_decides_as_jax_on_the_same_statuses(slos, probe_every):
    got = _drive(P, pslo, preg, slos, probe_every)
    want = _drive(J, jslo, jreg, slos, probe_every)
    assert got == want
    assert any(not d for ds, _, _ in got for d in ds)  # something shed


def _drive_forced(mod, reg_mod):
    reg = reg_mod.MetricRegistry()
    ctl = mod.AdmissionController(mod.AdmissionConfig(probe_every=3),
                                  registry=reg)
    trace = type("T", (), {"probe": False})()
    out = [ctl.admit(), ctl.engage({"alert_id": "a"}), ctl.stats()]
    out.append([ctl.admit(trace=trace) for _ in range(6)])
    out += [trace.probe, ctl.sheds, ctl.probes_admitted, reg.snapshot()]
    ctl.release({"alert_id": "a"})
    out += [ctl.admit(), ctl.stats(), reg.snapshot()]
    return out


def test_forced_shed_and_probe_trickle_as_jax():
    got = _drive_forced(P, preg)
    assert got == _drive_forced(J, jreg)
    assert got[3] == [False, False, True, False, False, True]
    assert "forced" not in got[-2]


def test_config_and_defaults_as_jax():
    assert P.DEFAULT_ADMISSION_SLOS == J.DEFAULT_ADMISSION_SLOS
    assert (dataclasses.asdict(P.AdmissionConfig())
            == dataclasses.asdict(J.AdmissionConfig()))
    for kw in ({"slo_names": ()}, {"probe_every": -1}):
        errs = []
        for mod in (P, J):
            with pytest.raises(ValueError) as e:
                mod.AdmissionConfig(**kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_live_observatory_burn_drives_shedding_as_jax():
    """Each package's own observatory over the same p99 rows: the
    listener sheds while the SLO burns and admits after the clear."""
    from npairloss_tpu.obs.live import LiveObservatory as JLive
    from npairloss_tpu_torch.obs.live import LiveObservatory as PLive

    rows = [(1.0, 10.0), (2.0, 900.0), (3.0, 900.0), (4.0, 900.0),
            (9.0, 10.0), (10.0, 10.0), (16.0, 10.0), (17.0, 10.0)]
    out = {}
    for name, mod, live_cls, slo_mod in (("port", P, PLive, pslo),
                                         ("jax", J, JLive, jslo)):
        spec = slo_mod.SLOSpec(name="serve_p99", metric="serve_p99_ms",
                               op="<=", target=150.0, window_s=3.0,
                               burn_threshold=0.5, min_samples=1)
        live = live_cls([spec], clock=lambda: 0.0)
        ctl = mod.controller_from_args(None, registry=live.registry,
                                       probe_every=4)
        live.add_listener(ctl.on_statuses)
        seen = []
        for t, p99 in rows:
            live.registry.set("serve_p99_ms", p99, t=t)
            live.tick(now=t)
            seen.append(([ctl.admit() for _ in range(5)],
                         live.registry.get("serve_shedding").value))
        live.stop(final_tick=False)
        out[name] = (seen, ctl.stats())
    assert out["port"] == out["jax"]
    assert [g for _, g in out["port"][0]] == [0, 1, 1, 1, 0, 0, 0, 0]


# -- the server's gate --------------------------------------------------------


class _FakeTel:
    metrics_enabled = True
    tracer = None

    def __init__(self):
        self.rows = []

    def span(self, name, **args):
        return contextlib.nullcontext()

    def instant(self, name, **args):
        pass

    def log(self, phase, step, row):
        self.rows.append(dict(row))

    def flush(self):
        pass


def _gallery():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((32, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, (np.arange(32) % 4).astype(np.int32)


def _servers(tel_port, tel_jax):
    from npairloss_tpu.serve import (
        BatcherConfig,
        EngineConfig,
        GalleryIndex,
        QueryEngine,
        RetrievalServer,
        ServerConfig,
    )
    from npairloss_tpu_torch.serve import batcher as pb
    from npairloss_tpu_torch.serve import engine as pe
    from npairloss_tpu_torch.serve import index as pi
    from npairloss_tpu_torch.serve import server as ps

    emb, lab = _gallery()
    jeng = QueryEngine(GalleryIndex.build(emb, lab, normalize=False),
                       EngineConfig(top_k=3, buckets=(1, 4)))
    jeng.warmup()
    jctl = J.AdmissionController(J.AdmissionConfig(probe_every=3))
    jsrv = RetrievalServer(jeng, BatcherConfig(max_batch=4,
                                               max_delay_ms=1.0),
                           ServerConfig(metrics_window=4),
                           telemetry=tel_jax, admission=jctl)
    peng = pe.QueryEngine(pi.GalleryIndex.build(emb, lab, normalize=False,
                                                device="cpu"),
                          pe.EngineConfig(top_k=3, buckets=(1, 4)))
    peng.warmup()
    pctl = P.AdmissionController(P.AdmissionConfig(probe_every=3))
    psrv = ps.RetrievalServer(peng, pb.BatcherConfig(max_batch=4,
                                                     max_delay_ms=1.0),
                              ps.ServerConfig(metrics_window=4),
                              telemetry=tel_port, admission=pctl)
    return {"port": (psrv, pctl), "jax": (jsrv, jctl)}


def test_server_sheds_and_counts_as_jax():
    tels = {"port": _FakeTel(), "jax": _FakeTel()}
    out = {}
    emb, _ = _gallery()
    for name, (srv, ctl) in _servers(tels["port"], tels["jax"]).items():
        srv.replicaset.start()
        answers = []
        try:
            for i in range(20):
                if i == 4:
                    ctl.engage()
                if i == 14:
                    ctl.release()
                answers.append(srv.handle_many(
                    [{"id": i, "embedding": emb[i].tolist()}])[0])
            health = srv.healthz()
        finally:
            srv.replicaset.close(drain=True)
        s = srv.summary()
        assert s["queries"] == (s["answered"] + s["errors"]
                                - s.get("errors_refused", 0) + s["rejected"])
        out[name] = (["error" in a for a in answers],
                     [a.get("error") for a in answers if "error" in a][:1],
                     {k: s[k] for k in ("queries", "answered", "rejected",
                                        "shed", "shedding")},
                     health["admission"],
                     [(r["rejected"], r.get("shed")) for r in tels[name].rows])
    assert out["port"] == out["jax"]
    shed = out["port"][0]
    assert sum(shed) == 7 and not any(shed[:4]) and not any(shed[14:])
    assert out["port"][1] == ["load shed: SLO burning (admission control); "
                              "retry after backoff"]


def test_serve_admission_slo_wires_the_burn_listener(tmp_path):
    from npairloss_tpu_torch.serve.index import GalleryIndex

    emb, lab = _gallery()
    GalleryIndex.build(emb, lab, device="cpu").save(str(tmp_path / "g.gidx"))
    args = cli.build_parser().parse_args([
        "serve", "--index", str(tmp_path / "g.gidx"), "--top-k", "3",
        "--device", "cpu", "--telemetry-dir", str(tmp_path / "tel"),
        "--live-obs", "--slo-tick", "3600", "--admission", "slo",
        "--admission-slos", "serve_p99"])
    server, _ = cli.build_server(args)
    try:
        ctl = server.admission
        assert ctl.cfg.slo_names == ("serve_p99",)
        assert ctl.on_statuses in server.live.listeners
        assert server.remediation is None
        man = json.load(open(tmp_path / "tel" / "manifest.json"))
        assert man["config"]["admission"] == "slo"
        assert man["config"]["remediate"] is False
    finally:
        server.replicaset.close(drain=True)
        cli.close_observers(server)


def test_load_shed_remediation_engages_and_releases(tmp_path):
    """``serve --remediate`` with ``--admission off``: the queue-
    saturation alert engages the forced-only controller (queries shed,
    ``serve_shedding`` 1), its resolve releases it and the attempt
    succeeds; the audit log validates against the alert log."""
    from npairloss_tpu_torch.obs.live.alerts import load_alert_log
    from npairloss_tpu_torch.resilience.remediate import (
        load_remediation_log,
        validate_remediation_log,
    )
    from npairloss_tpu_torch.serve.index import GalleryIndex

    emb, lab = _gallery()
    GalleryIndex.build(emb, lab, device="cpu").save(str(tmp_path / "g.gidx"))
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"slos": [{
        "name": "serve_queue_saturation", "metric": "serve_queue_depth",
        "op": "<=", "target": 4.0, "window_s": 2.0, "burn_threshold": 0.5,
        "min_samples": 1, "severity": "warning"}]}))
    rem = tmp_path / "rem.json"
    rem.write_text(json.dumps({"policies": [{
        "name": "load_shed", "slo": "serve_queue_saturation",
        "action": "load_shed", "cooldown_s": 1.0, "max_attempts": 2}]}))
    tel = tmp_path / "tel"
    args = cli.build_parser().parse_args([
        "serve", "--index", str(tmp_path / "g.gidx"), "--top-k", "3",
        "--device", "cpu", "--telemetry-dir", str(tel), "--live-obs",
        "--slo-config", str(slo), "--slo-tick", "3600", "--remediate",
        "--remediation-config", str(rem)])
    server, _ = cli.build_server(args)
    live = server.live
    server.replicaset.start()
    try:
        t0 = 1000.0
        live.registry.set("serve_queue_depth", 9.0, t=t0)
        live.tick(now=t0)
        assert server.admission.forced
        assert live.registry.get("serve_shedding").value == 1.0
        got = [server.handle_many([{"id": i, "embedding":
                                    emb[i].tolist()}])[0]
               for i in range(9)]
        assert sum("error" in a for a in got) == 8  # one probe admitted
        live.registry.set("serve_queue_depth", 0.0, t=t0 + 3.0)
        live.tick(now=t0 + 3.0)
        assert not server.admission.forced
        assert live.registry.get("serve_shedding").value == 0.0
        assert server.healthz()["remediation"]["load_shed"]["outcome"] \
            == "succeeded"
    finally:
        server.replicaset.close(drain=True)
        cli.close_observers(server)
    s = server.summary()
    assert s["rejected"] == s["shed"] == 8
    assert s["queries"] == s["answered"] + s["rejected"]
    recs = load_remediation_log(str(tel / "remediation.jsonl"))
    assert validate_remediation_log(
        recs, alert_records=load_alert_log(str(tel / "alerts.jsonl"))) is None
    assert [r["state"] for r in recs] == ["attempted", "succeeded"]


def test_compile_key_reaches_the_registry_after_a_shed():
    """The window row's ``shed`` maps to gauge ``serve_shed``, a name the
    controller's counter holds, so the sink stops the row there.  The
    port's row carries ``compiles_after_warmup`` before ``shed``, so the
    post-warmup-compile watchdog keeps its samples once a shed ran; the
    JAX row puts it after, and the reference's registry never sees it."""
    from npairloss_tpu.obs.live import LiveObservatory as JLive
    from npairloss_tpu_torch.obs.live import LiveObservatory as PLive

    tels = {}
    seen = {}
    for name, live_cls in (("port", PLive), ("jax", JLive)):
        live = live_cls([], clock=lambda: 0.0)
        tels[name] = live
    emb, _ = _gallery()

    class _Tel(_FakeTel):
        def __init__(self, live):
            super().__init__()
            self.live = live

        def log(self, phase, step, row):
            super().log(phase, step, row)
            self.live.sink.log({"phase": phase, "step": step,
                                "wall_time": 1.0, **row})

    servers = _servers(_Tel(tels["port"]), _Tel(tels["jax"]))
    for name, (srv, ctl) in servers.items():
        ctl.registry = tels[name].registry
        srv.replicaset.start()
        try:
            ctl.engage()
            srv._explicit_compile_key = True
            for i in range(12):
                srv.handle_many([{"id": i, "embedding": emb[i].tolist()}])
        finally:
            srv.replicaset.close(drain=True)
        assert any(r.get("shed") and "compiles_after_warmup" in r
                   for r in srv.telemetry.rows)
        seen[name] = tels[name].registry.get("serve_compiles_after_warmup")
    assert seen["port"] is not None and seen["port"].value == 0.0
    assert seen["jax"] is None
