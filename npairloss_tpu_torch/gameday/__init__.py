"""Production gameday (docs/RESILIENCE.md §8) — the port of
``npairloss_tpu/gameday``.

Deterministic traffic (:mod:`~npairloss_tpu_torch.gameday.traffic`), a
declarative chaos schedule (:mod:`~npairloss_tpu_torch.gameday.schedule`),
one supervised composed-system run
(:mod:`~npairloss_tpu_torch.gameday.runner`), and the versioned
``npairloss-gameday-v1`` verdict whose validator IS the pass/fail
contract (:mod:`~npairloss_tpu_torch.gameday.verdict` — stdlib-only, loaded
by file path without the package).  The runner launches the port's
CLI (``python -m npairloss_tpu_torch``) as its children.

The runner is deliberately NOT imported here: it pulls numpy, torch
and the serving stack, while traffic/schedule/verdict stay
stdlib-only.
"""

from npairloss_tpu_torch.gameday.schedule import (  # noqa: F401
    ChaosEntry,
    default_schedule,
    env_spec,
    load_schedule,
)
from npairloss_tpu_torch.gameday.traffic import (  # noqa: F401
    TrafficConfig,
    TrafficPlan,
    generate,
    plan_digest,
    plan_lines,
    plan_stats,
)
from npairloss_tpu_torch.gameday.verdict import (  # noqa: F401
    GAMEDAY_SCHEMA,
    build_gameday_report,
    load_gameday_report,
    validate_gameday_report,
)
