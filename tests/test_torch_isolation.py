"""The port stands alone: it never imports jax, flax or the JAX package,
its entry points refuse to drop to the CPU unasked, and a kernel wrapper
counts only launches of its kernel.

  * the CPU serve path (and with telemetry: the fleet report, the
    merged traces, ``prof --fleet``, ``timeline``, ``parse``,
    ``device-query`` and ``prof --step serve``), the train CLI (dense and ``--engine
    blockwise``) with one ``googlenet_pallas`` training step on each
    engine, ``train --resume auto`` with snapshots, ``extract`` and
    ``eval``, ``train --pipeline`` with the divergence guard armed, and
    the train CLI on a PPM list file (the Python loader and the native
    runtime) run in subprocesses whose ``import jax`` raises
    (a poisoned ``jax.py`` first on PYTHONPATH, the test_staticcheck
    trick), and ``jax`` never reaches ``sys.modules``;
  * an AST scan of every port module and ``chip_smoke.py`` finds no
    import of ``jax``, ``flax`` or ``npairloss_tpu`` (the ``pipeline/``,
    ``parallel/`` and ``obs/`` packages and ``resilience/guard.py`` named
    among the scanned files: the guard and the stdlib-only telemetry
    modules are copies, not imports);
  * entry points called without ``device=`` raise when CUDA is absent,
    the data loaders too;
  * kernel wrappers given CPU tensors leave their launch counters at 0.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from npairloss_tpu_torch import device as tdevice
from npairloss_tpu_torch.models import get_model
from npairloss_tpu_torch.ops import (
    _build,
    blockwise_npair,
    ivf_probe,
    kmeans,
    stem,
)
from npairloss_tpu_torch.ops.npair_loss import MiningMethod, NPairLossConfig
from npairloss_tpu_torch.serve.index import GalleryIndex, load_index
from npairloss_tpu_torch.serve.ivf import IVFIndex

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "npairloss_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "npairloss_tpu")

SERVE_SCRIPT = r"""
import io, json, sys
import numpy as np
from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
from npairloss_tpu_torch.serve.ivf import IVFIndex
from npairloss_tpu_torch.serve.server import RetrievalServer, ServerConfig
from npairloss_tpu_torch.models import get_model
rng = np.random.default_rng(0)
emb = rng.standard_normal((64, 1024)).astype(np.float32)
idx = IVFIndex.build_ivf(emb, np.arange(64), clusters=4, device="cpu")
eng = QueryEngine(idx, EngineConfig(top_k=3, buckets=(2,), probes=4,
                                    probe_impl="fused"),
                  model=get_model("googlenet_pallas", device="cpu"))
lines = [json.dumps({"id": 0, "embedding": emb[5].tolist()}),
         json.dumps({"id": 1, "input": np.zeros((32, 32, 3)).tolist()})]
out = io.StringIO()
RetrievalServer(eng, cfg=ServerConfig(explicit_drops=True)).run_jsonl(
    io.StringIO("\n".join(lines) + "\n"), out)
ans = [json.loads(x) for x in out.getvalue().splitlines()]
assert ans[0]["neighbors"][0]["row"] == 5, ans[0]
assert "neighbors" in ans[1], ans[1]
assert ans[-1]["queries_dropped"] == 0 and ans[-1]["answered"] == 2
# Serving's telemetry, the fleet observatory and the small commands.
import contextlib, os
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.obs import RunTelemetry
from npairloss_tpu_torch.obs.fleet import (
    build_fleet_report, merge_run_traces, merge_timeline,
    validate_fleet_report)
from npairloss_tpu_torch.obs.fleet.comms import (
    comm_rows_from_counts, effective_bandwidth)
from npairloss_tpu_torch.utils.debug import assert_all_finite, checked
from npairloss_tpu_torch.tools import e2e_real_jpeg
tel = RunTelemetry("tel")
eng2 = QueryEngine(idx, EngineConfig(top_k=3, buckets=(2,), probes=4),
                   telemetry=tel)
eng2.warmup()
RetrievalServer(eng2, cfg=ServerConfig(metrics_window=1),
                telemetry=tel).run_jsonl(io.StringIO(lines[0] + "\n"),
                                         io.StringIO())
tel.close()
report = build_fleet_report("tel")
assert validate_fleet_report(report) is None, report
assert merge_run_traces("tel")[0] and merge_timeline("tel")[0]
assert effective_bandwidth(comm_rows_from_counts({}), 1.0, "cpu", "gloo")
assert_all_finite({"loss": 1.0})
with contextlib.redirect_stdout(io.StringIO()):
    for argv in (["parse", os.environ["TINY_SOLVER"], "--json"],
                 ["device-query", "--device", "cpu"],
                 ["prof", "--fleet", "tel"], ["timeline", "tel"],
                 ["prof", "--step", "serve", "--gallery", "64", "--dim", "8",
                  "--device", "cpu", "--out", "prof"]):
        assert cli.main(argv) == 0, argv
assert not any(m == "jax" or m.startswith(("jax.", "flax", "npairloss_tpu."))
               for m in sys.modules), sorted(sys.modules)
print("ISOLATED-OK")
"""


def test_cpu_serve_path_runs_with_jax_poisoned(tmp_path):
    poison = tmp_path / "poison"
    poison.mkdir()
    for mod in ("jax", "flax"):
        (poison / f"{mod}.py").write_text(
            f'raise ImportError("{mod} imported by the torch port")\n')
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{poison}{os.pathsep}{REPO}"
    env["TINY_SOLVER"] = str(REPO / "examples" / "tiny_solver.prototxt")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", SERVE_SCRIPT],
                          capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED-OK" in proc.stdout


TRAIN_SCRIPT = r"""
import sys
import numpy as np
import torch
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.models import get_model
from npairloss_tpu_torch.train.solver import Solver, SolverConfig
for engine in ("dense", "blockwise"):
    rc = cli.main(["train", "--solver", "examples/tiny_solver.prototxt",
                   "--synthetic", "--device", "cpu", "--max_iter", "2",
                   "--engine", engine])
    assert rc == 0, rc
    model = get_model("googlenet_pallas", device="cpu", dtype=torch.float32)
    solver = Solver(model, cfg=SolverConfig(snapshot=0), engine=engine)
    rng = np.random.default_rng(0)
    m = solver.step(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                    np.array([0, 0, 1, 1]))
    assert np.isfinite(float(m["loss"]))
    assert solver.params["conv1.Conv_0.weight"].grad is not None
# The ResNet trunk family (resnet18) at a tiny input, on both engines.
for engine in ("dense", "blockwise"):
    rc = cli.main(["train", "--solver", "examples/tiny_solver.prototxt",
                   "--synthetic", "--device", "cpu", "--max_iter", "2",
                   "--engine", engine, "--model", "resnet18"])
    assert rc == 0, rc
# Snapshots and resume, then extract and eval on what they wrote.
work = sys.argv[1]
solver_path = work + "/solver.prototxt"
open(solver_path, "w").write(
    open("examples/tiny_solver.prototxt").read()
    .replace("snapshot: 0", "snapshot: 2")
    .replace('snapshot_prefix: "/tmp/npair_snap_"',
             f'snapshot_prefix: "{work}/m_"'))
for max_iter in ("2", "4"):
    rc = cli.main(["train", "--solver", solver_path, "--synthetic",
                   "--device", "cpu", "--max_iter", max_iter, "--resume",
                   "auto"])
    assert rc == 0, rc
rc = cli.main(["extract", "--solver", solver_path, "--synthetic", "--device",
               "cpu", "--resume", "auto", "--batches", "2", "--out",
               work + "/f"])
assert rc == 0, rc
rc = cli.main(["eval", "--prefix", work + "/f", "--device", "cpu", "--nmi"])
assert rc == 0, rc
# The pipelined loop with the divergence guard armed, on both engines.
for engine in ("dense", "blockwise"):
    rc = cli.main(["train", "--solver", solver_path, "--synthetic",
                   "--device", "cpu", "--max_iter", "4", "--pipeline",
                   "--divergence-patience", "2", "--engine", engine,
                   "--snapshot_prefix", work + "/p_" + engine + "_",
                   "--compile-cache", work + "/cc"])
    assert rc == 0, rc
assert not any(k == "jax" or k.startswith(("jax.", "flax", "npairloss_tpu."))
               for k in sys.modules), sorted(sys.modules)
print("ISOLATED-TRAIN-OK")
"""


def test_cpu_train_path_runs_with_jax_poisoned(tmp_path):
    """The train CLI (config, data, solver, loss, metrics) and one
    ``googlenet_pallas`` training step through the stem Functions, on the
    dense and the blockwise engine; ``train --model resnet18`` at the tiny
    net's 8x8 crop on both engines; then ``train --resume auto`` (a fresh
    start, then a restore), ``extract`` and ``eval`` on its output."""
    poison = tmp_path / "poison"
    poison.mkdir()
    for mod in ("jax", "flax"):
        (poison / f"{mod}.py").write_text(
            f'raise ImportError("{mod} imported by the torch port")\n')
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{poison}{os.pathsep}{REPO}"
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", TRAIN_SCRIPT,
                           str(tmp_path)], capture_output=True, text=True,
                          env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED-TRAIN-OK" in proc.stdout
    assert "resuming from iteration 2" in proc.stdout


LIST_TRAIN_SCRIPT = r"""
import pathlib, re, sys
import numpy as np
from npairloss_tpu_torch import cli
root = pathlib.Path("images")
root.mkdir()
rng = np.random.default_rng(0)
rows = []
for ident in range(8):
    for k in range(2):
        name = f"{ident}_{k}.ppm"
        (root / name).write_bytes(b"P6\n9 11\n255\n" + rng.integers(
            0, 256, (11, 9, 3), dtype=np.uint8).tobytes())
        rows.append(f"{name} {ident}")
pathlib.Path("list.txt").write_text("\n".join(rows) + "\n")
net = open(sys.argv[1] + "/examples/tiny_net.prototxt").read().replace(
    "multi_batch_data_param {", 'multi_batch_data_param {\n'
    'root_folder: "images/"\nsource: "list.txt"\n'
    "new_height: 10\nnew_width: 10")
net = net.replace("crop_size: 8", "crop_size: 8 mirror: true")
pathlib.Path("net.prototxt").write_text(net)
for native in ("never", "require"):
    rc = cli.main(["train", "--solver",
                   sys.argv[1] + "/examples/tiny_solver.prototxt", "--net",
                   "net.prototxt", "--device", "cpu", "--max_iter", "2",
                   "--native", native])
    assert rc == 0, rc
assert not any(k == "jax" or k.startswith(("jax.", "flax", "npairloss_tpu."))
               for k in sys.modules), sorted(sys.modules)
print("ISOLATED-LIST-TRAIN-OK")
"""


def test_cpu_list_file_train_path_runs_with_jax_poisoned(tmp_path):
    """``train`` on a PPM list file without ``--synthetic``, through the
    Python loader and the native runtime, with a random crop and mirror
    on the device side."""
    poison = tmp_path / "poison"
    poison.mkdir()
    for mod in ("jax", "flax"):
        (poison / f"{mod}.py").write_text(
            f'raise ImportError("{mod} imported by the torch port")\n')
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{poison}{os.pathsep}{REPO}"
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", LIST_TRAIN_SCRIPT,
                           str(REPO)], capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED-LIST-TRAIN-OK" in proc.stdout


def test_data_loaders_raise_without_cuda(monkeypatch, tmp_path):
    """The loaders resolve ``device=None`` to the card, and raise without
    one instead of loading onto the CPU."""
    from npairloss_tpu_torch.config.schema import DataLayerConfig
    from npairloss_tpu_torch.data import ArrayDataset, multibatch_loader
    from npairloss_tpu_torch.data.loader import MultibatchLoader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "l.txt").write_text("a.ppm 0\nb.ppm 1\n")
    cfg = DataLayerConfig(source=str(tmp_path / "l.txt"),
                          identity_num_per_batch=2, img_num_per_identity=1)
    for native in ("never", "require"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multibatch_loader(dataclasses.replace(cfg, new_height=4,
                                                  new_width=4),
                              native=native)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultibatchLoader(ArrayDataset(np.zeros((2, 4, 4, 3), np.uint8),
                                      np.arange(2)), cfg)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    return files


def test_no_port_module_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        for name in _imports(path):
            root = name.split(".")[0]
            if root in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {name}")
    assert bad == []


@pytest.mark.parametrize("module", [
    "pipeline/__init__.py", "pipeline/compile_cache.py",
    "pipeline/controller.py", "pipeline/prefetcher.py",
    "pipeline/syncguard.py", "pipeline/window.py", "resilience/guard.py",
    "parallel/__init__.py", "parallel/distributed.py", "parallel/launch.py",
    "parallel/mesh.py", "parallel/meshcheck.py", "parallel/plan.py",
    "parallel/ring.py", "obs/__init__.py", "obs/sinks.py", "obs/tracing.py",
    "obs/manifest.py", "obs/run.py", "obs/health.py", "obs/fleet/__init__.py",
    "obs/fleet/stamp.py", "obs/perf/__init__.py", "obs/perf/costs.py",
    "obs/perf/count.py", "obs/perf/decompose.py", "obs/perf/report.py",
    "obs/perf/roofline.py", "models/resnet.py", "models/vit.py",
    "models/caffe_import.py", "config/caffemodel.py", "tools/vit_stretch.py",
    "obs/fleet/aggregate.py", "obs/fleet/comms.py",
    "obs/fleet/merge_traces.py", "utils/__init__.py", "utils/debug.py",
    "tools/e2e_real_jpeg.py", "tools/phase_times.py",
])
def test_pipeline_and_guard_modules_are_scanned_and_clean(module):
    path = PORT / module
    assert path in _port_files()
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & set(FORBIDDEN), roots


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb = np.eye(4, dtype=np.float32)
    lab = np.arange(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GalleryIndex.build(emb, lab)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IVFIndex.build_ivf(emb, lab, clusters=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("googlenet_pallas")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans.kmeans_fit(emb, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_load_index_without_device_raises(monkeypatch, tmp_path):
    idx = GalleryIndex.build(np.eye(4, dtype=np.float32), np.arange(4),
                             device="cpu")
    path = idx.save(str(tmp_path / "a.gidx"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_index(path)
    assert load_index(path, device="cpu").size == 4


def test_kernel_wrappers_on_cpu_tensors_count_no_launch():
    _build.reset_launch_counts()
    x = torch.randn(2, 6, 6, 64)
    b = torch.randn(64)
    xg = x.clone().requires_grad_()
    out, d = stem.lrn_fwd_cached(x)
    stem.lrn_bwd_cached(x, out, d)
    stem.lrn_bwd(x, out)
    stem.fused_lrn(xg).sum().backward()
    stem.fused_lrn(xg, cache=False).sum().backward()
    stem.fused_bias_relu(xg, b).sum().backward()
    stem.fused_bias_relu_pool(xg, b).sum().backward()
    packed = torch.randn(3, 5, 64)
    rows = torch.arange(15, dtype=torch.int32).reshape(3, 5)
    ivf_probe.fused_probe_topk(torch.randn(2, 64), packed, rows,
                               torch.randn(3, 64),
                               torch.ones(3, dtype=torch.bool),
                               k=4, probes=2, scoring="fp32")
    # All five blockwise sweeps: stats, the hist digits of the radix
    # path (pos_topk 0), loss, and gq/gdb in the backward.
    f = torch.nn.functional.normalize(torch.randn(8, 16), dim=1)
    f.requires_grad_()
    loss = blockwise_npair.blockwise_npair_loss(
        f, torch.tensor([0, 0, 1, 1, 2, 2, 3, 3]),
        NPairLossConfig(ap_mining_method=MiningMethod.RELATIVE_HARD,
                        identsn=-0.5), block_size=4, pos_topk=0)
    loss.backward()
    assert f.grad is not None
    counts = _build.launch_counts()
    assert set(counts) == {"lrn_fwd", "lrn_fwd_cached", "lrn_bwd",
                           "lrn_bwd_cached", "fused_bias_relu",
                           "fused_bias_relu_pool", "probe_topk",
                           "npair_stats", "npair_hist", "npair_loss",
                           "npair_gq", "npair_gdb", "round_bf16"} | {
        f"{k}:bf16" for k in ("npair_stats", "npair_hist", "npair_loss",
                              "npair_gq", "npair_gdb")}
    assert all(v == 0 for v in counts.values()), counts


def test_importing_the_port_builds_nothing():
    """No kernel is built or loaded at import: the library handle stays
    empty until a CUDA tensor reaches a wrapper."""
    assert _build._lib is None
    assert _build.build_info == {}
