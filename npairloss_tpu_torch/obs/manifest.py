"""Run manifests — the "what exactly ran?" snapshot written at run start;
port of ``npairloss_tpu/obs/manifest.py``.

``RunManifest`` captures the config snapshot, the device and mesh
topology, the package version, the git sha and host info — written as
``manifest.json`` before the first step so even a crashed run is
diagnosable from disk.

Stdlib only at import time; torch is consulted lazily, and CUDA only
when it is already initialized (telemetry never initializes a device).
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import subprocess
import sys
import time
from typing import Any, Dict, Optional


def git_sha(repo_dir: Optional[str] = None) -> Optional[str]:
    """HEAD sha of the repo containing ``repo_dir`` (default: this
    package's checkout), or None outside a git checkout / without git.

    With no ``repo_dir`` the sha is recorded only when the package's
    ``__init__.py`` is tracked by the enclosing repo: an installed
    package that merely sits inside some unrelated checkout records
    None, not that repo's HEAD."""
    anchor = None
    if repo_dir is None:
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        anchor = os.path.join(pkg_dir, "__init__.py")
        repo_dir = pkg_dir
    try:
        if anchor is not None:
            tracked = subprocess.run(
                ["git", "-C", repo_dir, "ls-files", "--error-unmatch",
                 anchor],
                capture_output=True, timeout=10,
            )
            if tracked.returncode != 0:
                return None
        out = subprocess.run(
            ["git", "-C", repo_dir, "rev-parse", "HEAD"],
            capture_output=True, timeout=10,
        )
        if out.returncode == 0:
            return out.stdout.decode().strip() or None
    except Exception:
        pass
    return None


def package_version() -> Optional[str]:
    """``npairloss_tpu_torch.__version__``."""
    try:
        import npairloss_tpu_torch

        return npairloss_tpu_torch.__version__
    except Exception:
        return None


def device_topology() -> Optional[Dict[str, Any]]:
    """torch and CUDA versions, and the devices when CUDA is ALREADY
    initialized; the process group's rank and size when one is; None
    when torch is not imported."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        out: Dict[str, Any] = {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }
        if torch.cuda.is_initialized():
            out["devices"] = [
                {"id": i, "platform": "gpu",
                 "device_kind": torch.cuda.get_device_name(i)}
                for i in range(torch.cuda.device_count())
            ]
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() and dist.is_initialized():
            out["process_index"] = dist.get_rank()
            out["process_count"] = dist.get_world_size()
            out["backend"] = str(dist.get_backend())
        return out
    except Exception:
        return None


@dataclasses.dataclass
class RunManifest:
    """One run's provenance record.  ``config`` is the caller's config
    snapshot (anything JSON-able; other leaves are stringified)."""

    run_id: str
    created: float = dataclasses.field(default_factory=time.time)
    config: Optional[Dict[str, Any]] = None
    topology: Optional[Dict[str, Any]] = None
    mesh: Optional[Dict[str, Any]] = None
    package_version: Optional[str] = None
    git_sha: Optional[str] = None
    argv: Optional[list] = None
    host: Optional[Dict[str, Any]] = None
    # The fleet identity the telemetry layer stamped for the WRITING
    # process ({process_index, process_count, local_device_ids}).
    fleet: Optional[Dict[str, Any]] = None
    extra: Optional[Dict[str, Any]] = None

    @classmethod
    def collect(
        cls,
        run_id: str,
        config: Optional[Dict[str, Any]] = None,
        mesh: Optional[Dict[str, Any]] = None,
        fleet: Optional[Dict[str, Any]] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> "RunManifest":
        """Gather the ambient provenance around the caller's config."""
        return cls(
            run_id=run_id,
            config=config,
            topology=device_topology(),
            mesh=mesh,
            package_version=package_version(),
            git_sha=git_sha(),
            argv=list(sys.argv),
            host={
                "platform": platform.platform(),
                "python": platform.python_version(),
                "pid": os.getpid(),
            },
            fleet=fleet,
            extra=extra,
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def write(self, path: str) -> str:
        """Write ``manifest.json`` atomically; returns the path."""
        path = os.path.abspath(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=str)
            f.write("\n")
        os.replace(tmp, path)
        return path
