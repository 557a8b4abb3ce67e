"""Utilities — port of ``npairloss_tpu/utils`` (its numerical debug
guards; the device profiling helpers are ``torch.profiler`` and
``obs``)."""

from npairloss_tpu_torch.utils.debug import (
    assert_all_finite,
    checked,
    debug_checks_enabled,
    enable_debug_checks,
)

__all__ = [
    "assert_all_finite",
    "checked",
    "debug_checks_enabled",
    "enable_debug_checks",
]
