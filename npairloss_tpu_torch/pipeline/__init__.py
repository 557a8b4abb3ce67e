"""Sync-free stepping — the pipelined training loop's parts (port of
``npairloss_tpu/pipeline``).

The synchronous loop issues every step from the training thread: the
loader's dispatch (upload, augmentation), then the step's several
hundred kernel launches, one Python call each, while the card waits on
the host between them.  This package removes the steady-state host
taxes:

  * :class:`DevicePrefetcher` — a staging thread that pulls loader
    batches and places them on the card on its own CUDA stream ahead of
    need;
  * :class:`DispatchController` — a bound on in-flight dispatched
    steps, waiting on CUDA events, so the host cannot queue unboundedly
    ahead of the card;
  * :class:`MetricWindow` — a device-side metric ring written by the
    step (plus a device-side consecutive-non-finite loss counter), read
    back by the host only at display/test/snapshot window boundaries;
  * :func:`enable_compile_cache` — a shared build directory for the
    nvcc-built kernel library and the native runtime;
  * :class:`HostSyncMonitor` — a counting shim over ``device.upload``/
    ``device.fetch`` that proves (or enforces) the no-mid-window-host-
    sync contract.

The Solver wires these together behind ``SolverConfig.pipeline`` (CLI
``--pipeline``), default OFF; on a card the pipelined step is captured
once as a CUDA graph and replayed, and the loop is held bit-identical
to the synchronous one (tests/test_torch_pipeline.py, chip_smoke phase
5h).
"""

from npairloss_tpu_torch.pipeline.compile_cache import (
    compile_cache_dir,
    disable_compile_cache,
    enable_compile_cache,
)
from npairloss_tpu_torch.pipeline.controller import DispatchController
from npairloss_tpu_torch.pipeline.prefetcher import (
    DevicePrefetcher,
    PrefetchStageError,
)
from npairloss_tpu_torch.pipeline.syncguard import (
    HostSyncMonitor,
    SyncGuardViolation,
    monitor_from_env,
)
from npairloss_tpu_torch.pipeline.window import MetricWindow

__all__ = [
    "DevicePrefetcher",
    "DispatchController",
    "HostSyncMonitor",
    "MetricWindow",
    "PrefetchStageError",
    "SyncGuardViolation",
    "compile_cache_dir",
    "disable_compile_cache",
    "enable_compile_cache",
    "monitor_from_env",
]
