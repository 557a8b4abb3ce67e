"""The finding model every staticcheck pass speaks.

A finding is one violated invariant at one place: ``(pass_name, path,
line, key, message)``.  The ``key`` is the stable identity used by the
allowlist — deliberately line-number-free (``pass:path:detail``) so an
unrelated edit above a tolerated finding does not un-suppress it.

A copy of ``npairloss_tpu/analysis/findings.py``.  Stdlib-only and
self-contained: the whole analysis chain runs, and loads by file path,
in a process without torch (docs/STATICCHECK.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation.

    ``path`` is root-relative with forward slashes; ``line`` is
    1-based (0 = whole-file / cross-file finding anchored at ``path``);
    ``detail`` names the symbol or vocabulary item, NOT the position.
    """

    pass_name: str
    path: str
    line: int
    detail: str
    message: str

    @property
    def key(self) -> str:
        return f"{self.pass_name}:{self.path}:{self.detail}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "pass": self.pass_name,
            "path": self.path,
            "line": self.line,
            "key": self.key,
            "message": self.message,
        }

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"[{self.pass_name}] {loc}: {self.message}"
