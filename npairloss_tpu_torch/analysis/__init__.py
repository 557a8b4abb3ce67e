"""npairloss_tpu_torch.analysis — the invariant linter (staticcheck) over
the port's tree.

The port of ``npairloss_tpu/analysis``: an AST-based static-analysis
suite (stdlib ``ast`` + an import-graph walker, itself free of torch)
that enforces at lint time the contracts the runtime checks can only
catch after the fact — often only on a card (docs/STATICCHECK.md):

  * ``purity``     — transitive proof that the port's stdlib contract
                     modules import no torch, with a loud opt-in table;
  * ``scopes``     — every ``torch.distributed`` collective lexically
                     inside a ``count.collective`` block (its
                     ``comm/<kind>`` claim in the fleet comms count);
  * ``locks``      — ``# guarded-by:`` mutation discipline on shared
                     state (MetricRegistry, SLOEvaluator,
                     RemediationEngine, RetrievalServer swap state);
  * ``contracts``  — versioned ``npairloss-*-v1`` writer/validator
                     pairing, key twins, writer pins;
  * ``vocab``      — failpoints / CLI flags / choice pins / watchdog
                     names match their documented tables;
  * ``markers``    — tier-1 timing history vs ``@pytest.mark.slow``.

Every module here is stdlib-only and self-contained enough to load by
file path in a process without torch — the same contract as
``obs.live.alerts``, and the first thing the ``purity`` pass proves
about this very package.
"""

from npairloss_tpu_torch.analysis.findings import Finding
from npairloss_tpu_torch.analysis.report import (
    STATICCHECK_SCHEMA,
    build_report,
    load_report,
    validate_staticcheck_report,
    write_report,
)
from npairloss_tpu_torch.analysis.runner import (
    PASS_NAMES,
    load_allowlist,
    run_suite,
)

__all__ = [
    "Finding",
    "STATICCHECK_SCHEMA",
    "PASS_NAMES",
    "build_report",
    "load_report",
    "validate_staticcheck_report",
    "write_report",
    "load_allowlist",
    "run_suite",
]
