"""ProbeEscalator — the recall-burn remediation actuator.

Port of ``npairloss_tpu/obs/quality/escalate.py``.  When the recall-floor
SLO burns (the shadow scorer's ``serve_recall_at_{k}`` gauge under the
declared floor), the cheapest knob that buys recall back is the IVF
probe width: score more clusters per query.  ``probes`` is part of the
engine's ``EngineConfig``, so an escalation is a HOT-SWAP, not a flag
flip: build a fresh engine tier with the widened config, warm every
padding bucket off the serving path (the old tier keeps answering),
then publish it through :meth:`RetrievalServer.swap_engines` — zero
dropped queries and a post-warmup compile count of 0, the hot-swap's
contract (``serve/hotswap.py``).

The ladder doubles ``probes`` per attempt up to the cluster count; with
the probe budget spent (probing every cluster is the exact answer set,
only slower) the next attempt **falls back to flat scoring**: the tier
republishes on a flat ``GalleryIndex`` of the same gallery rows, in the
same row order (so the flat scan's lowest-index tie rule picks what
JAX's picks), with the same ``created`` stamp and ingest watermark
(the served index never changes in place: acked rows wait in the
ingest's pending list for the next checkpoint, as in JAX), scored in
fp32 where the tier scored int8 (the per-cluster scale has no flat equivalent).  A
further attempt on a flat tier raises :class:`EscalationExhaustedError`,
which the remediation engine records as a FAILED attempt, as
``NothingNewerError``.  Every rung runs the fused probe kernel when the
tier does: the kernel takes any probe count.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

log = logging.getLogger("npairloss_tpu_torch.obs.quality")


class EscalationExhaustedError(RuntimeError):
    """The tier already serves flat exact answers: no knob remains."""


class ProbeEscalator:
    """Escalate the served IVF probe width; flat fallback past it.

    ``factor`` multiplies ``probes`` per attempt (clamped to the cluster
    count).  The CURRENT tier is read from the server at each call, so
    escalations chain across interleaved hot-swaps (a snapshot swap
    keeps the escalated config: it reuses ``old.cfg``).
    ``escalate(alert=None)`` is the remediation-action signature; the
    returned detail dict lands on the audit record.
    """

    def __init__(self, server, telemetry=None, factor: int = 2):
        if factor < 2:
            raise ValueError(f"factor must be >= 2, got {factor}")
        self.server = server
        self.telemetry = telemetry
        self.factor = factor

    def escalate(self, alert: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        from npairloss_tpu_torch.serve.engine import QueryEngine
        from npairloss_tpu_torch.serve.index import GalleryIndex
        from npairloss_tpu_torch.serve.ivf import IVFIndex

        server = self.server
        old = server.engine
        index = old.index
        if not isinstance(index, IVFIndex):
            raise EscalationExhaustedError(
                "serving tier is already flat (exact scan) — probe "
                "escalation has nothing left to widen"
                + (f" (alert {alert.get('alert_id')})" if alert else ""))
        kc = index.n_clusters
        effective = min(old.cfg.probes, kc)
        if effective < kc:
            new_probes = min(effective * self.factor, kc)
            cfg = dataclasses.replace(old.cfg, probes=new_probes)
            new_index = index
            detail: Dict[str, Any] = {"probes": new_probes,
                                      "probes_before": effective}
            log.warning("recall remediation: escalating IVF probes "
                        "%d -> %d (of %d clusters)",
                        effective, new_probes, kc)
        else:
            # Probing every cluster already is the exact answer set: the
            # remaining knob is the flat scan itself, in fp32 where the
            # tier scored int8.
            cfg = dataclasses.replace(
                old.cfg,
                scoring=("fp32" if old.cfg.scoring == "int8"
                         else old.cfg.scoring))
            new_index = GalleryIndex.build(
                index.host_emb, index.host_labels, ids=index.ids,
                normalize=False, device=index.device)
            # Same content, same age, same watermark.
            new_index.created = index.created
            new_index.ingest_watermark = index.ingest_watermark
            detail = {"fallback": "flat", "probes_before": effective}
            log.warning("recall remediation: probe budget exhausted "
                        "(%d/%d) — falling back to the flat exact scan",
                        effective, kc)
        primary = QueryEngine(new_index, cfg, model=old.model,
                              telemetry=self.telemetry)
        warmup_s = primary.warmup(
            server.input_shape if old.model is not None else None)
        engines = [primary] + [
            QueryEngine(new_index, cfg, share_compiled_with=primary)
            for _ in range(len(server.engines) - 1)]
        # Same gallery content, same freshness identity: None keeps the
        # served ages (a recall remediation is no freshness event).
        server.swap_engines(engines, None)
        detail["warmup_s"] = round(warmup_s, 3)
        if self.telemetry is not None:
            self.telemetry.instant("serve/probe_escalation", **detail)
        return detail
