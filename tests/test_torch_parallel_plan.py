"""Engine planning, ring order and mesh plumbing of the port
(``npairloss_tpu_torch/parallel/{plan,mesh,distributed}.py``) against
the JAX package's ``parallel/plan.py`` and ``mesh.py``.

``plan_engine`` is held to the JAX rule with the JAX roofline's peaks
monkeypatched (inside the test only) to the H100 SXM figures the port's
table carries: every field equal, the link names mapped (ici -> nvlink,
dcn -> network), the floats within 1e-12 relative.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from npairloss_tpu_torch.parallel import (
    Mesh,
    build_mesh,
    data_parallel_mesh,
    host_counts,
    initialize_distributed,
    mesh_topology,
    plan_engine,
    plan_for_mesh,
    process_local_batch,
    process_topology,
    ring_device_order,
    shard_batch,
)
from npairloss_tpu_torch.parallel import plan as tplan

LINKS = {"ici": "nvlink", "dcn": "network"}


@pytest.fixture
def h100_jax_peaks(monkeypatch):
    from npairloss_tpu.obs.perf import roofline

    spec = roofline.ChipSpec("NVIDIA H100 SXM", 989e12, 3.35e12, 450e9,
                             50e9, known=True)
    monkeypatch.setattr(roofline, "chip_peaks", lambda kind: spec)
    monkeypatch.setattr(roofline, "interconnect_peak",
                        lambda s, link: {"ici": 450e9, "dcn": 50e9}[link])


TOPOLOGIES = [
    # (devices, hosts, shard rows, emb dim, requested)
    (1, 1, 120, 1024, "auto"),
    (2, 1, 60, 1024, "auto"),
    (8, 1, 120, 1024, "auto"),
    (8, 1, 16384, 512, "auto"),       # sim block past the 2 GiB budget
    (16, 2, 120, 1024, "auto"),       # hop does not hide
    (16, 2, 8192, 1024, "auto"),      # hop hides under the matmul
    (4, 2, 120, 1024, "ring"),
    (8, 1, 120, 1024, "dense"),
]


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_plan_engine_matches_jax_rule(h100_jax_peaks, topo):
    from npairloss_tpu.parallel.plan import plan_engine as jax_plan

    n, hosts, rows, dim, req = topo
    want = jax_plan(n, hosts, rows, dim, device_kind="NVIDIA H100 80GB HBM3",
                    requested=req).to_dict()
    got = plan_engine(n, hosts, rows, dim,
                      device_kind="NVIDIA H100 80GB HBM3",
                      requested=req).to_dict()
    assert list(got) == list(want)
    assert got["link"] == LINKS[want["link"]]
    for k, v in want.items():
        if k in ("link", "reason"):
            continue
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
        else:
            assert got[k] == v, k
    assert got["reason"].split(" over ")[0] == want["reason"].split(
        " over ")[0]


def test_unknown_kind_is_flagged_not_a_tpu_roofline():
    p = plan_engine(4, 1, 120, 1024, device_kind="cpu")
    assert p.peak_known is False
    assert p.peak_bytes_per_s == tplan.H100_SXM.links["nvlink"]
    assert "planned with the H100 SXM's" in p.reason
    assert plan_engine(4, 1, 120, 1024,
                       device_kind="NVIDIA H100 80GB HBM3").peak_known
    with pytest.raises(ValueError, match="unknown engine"):
        plan_engine(2, 1, 8, 8, requested="sparse")
    with pytest.raises(ValueError, match="bad topology"):
        plan_engine(2, 3, 8, 8)


@dataclasses.dataclass
class _Dev:
    id: int
    process_index: int


def test_ring_order_and_host_counts_match_jax():
    from npairloss_tpu.parallel.plan import host_counts as jax_hosts
    from npairloss_tpu.parallel.plan import ring_device_order as jax_order

    rng = np.random.default_rng(0)
    devs = [_Dev(i, int(h)) for i, h in enumerate(rng.integers(0, 3, 12))]
    rng.shuffle(devs)
    assert [d.id for d in ring_device_order(devs)] == [
        d.id for d in jax_order(devs)]
    assert host_counts(devs) == jax_hosts(devs)
    order = ring_device_order(devs)
    hosts = [d.process_index for d in order]
    assert hosts == sorted(hosts)


def test_mesh_topology_keys_match_jax():
    import jax

    from npairloss_tpu.parallel import data_parallel_mesh as jax_mesh
    from npairloss_tpu.parallel import mesh_topology as jax_topology

    want = jax_topology(jax_mesh(jax.devices()[:4]))
    mesh = Mesh(rank=1, size=4, device=torch.device("cpu"),
                ring=(0, 1, 2, 3), hosts=(0, 0, 1, 1),
                device_ids=(0, 1, 0, 1), backend="gloo")
    got = mesh_topology(mesh)
    assert list(got) == list(want)
    assert got["axes"] == {"dp": 4} and got["devices"] == 4
    assert got["device_process"] == [0, 1, 2, 3]
    assert got["process_index"] == 1
    plan = plan_for_mesh(mesh, 120, 1024)
    assert (plan.devices, plan.hosts, plan.shard_rows) == (4, 2, 30)
    assert plan.link == "network"


def test_mesh_without_process_group_is_one_shard():
    """No process group and no torchrun environment: initialization is a
    no-op and the mesh is one shard whose collectives are identities."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        assert k not in os.environ
    assert initialize_distributed() is False
    assert process_topology() == {"process_index": 0, "process_count": 1,
                                  "local_device_ids": [0]}
    mesh = data_parallel_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_gather(t) is t and mesh.all_reduce_sum(t) is t
    assert mesh.shift([t])[0] is t and mesh.agree(True)
    x, lab = shard_batch(mesh, (np.ones((4, 2), np.float32), np.arange(4)))
    assert x.shape == (4, 2) and lab.shape == (4,)
    y, _ = process_local_batch(mesh, (np.ones((2, 2)), np.arange(2)))
    assert y.device.type == "cpu"
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(Mesh(rank=0, size=3, device=torch.device("cpu")),
                    (np.ones((4, 2)),))


def test_rank_binds_its_local_card_when_device_names_no_index(
        monkeypatch, tmp_path):
    """``--device cuda`` in a process group (torch.cuda faked, LOCAL_RANK
    1): the run's device, the mesh's device, its topology and the NCCL
    barrier's ``device_ids`` all name card 1, not an index-less card."""
    import argparse

    import torch.distributed as dist

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.parallel import shutdown_distributed

    current = {"index": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: current.update(index=torch.device(d).index))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: current["index"])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "fake")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setenv("LOCAL_RANK", "1")
    try:
        assert initialize_distributed(f"file://{tmp_path}/pg", 1, 0,
                                      backend="gloo", device="cuda")
        dev = cli._run_device(argparse.Namespace(device="cuda"))
        assert dev == torch.device("cuda", 1)
        assert current["index"] == 1
        assert process_topology()["local_device_ids"] == [1]
        for mesh in (build_mesh(device=dev), data_parallel_mesh("cuda")):
            assert mesh.device == torch.device("cuda", 1)
            assert mesh_topology(mesh)["device_ids"] == [1]
            seen = []
            monkeypatch.setattr(dist, "barrier",
                                lambda **kw: seen.append(kw["device_ids"]))
            dataclasses.replace(mesh, backend="nccl").barrier()
            assert seen == [[1]]
    finally:
        shutdown_distributed()


def test_build_mesh_refuses_model_parallel():
    with pytest.raises(NotImplementedError, match="partition.py and --mp"):
        build_mesh(mp=2, device="cpu")
    assert build_mesh(mp=1, device="cpu").size == 1


def test_partial_launch_flags_are_refused():
    with pytest.raises(ValueError, match="go together"):
        initialize_distributed("localhost:1", None, 0, device="cpu")


def test_meshcheck_holds_over_gloo_at_two_ranks(tmp_path):
    """``parallel.meshcheck`` under torchrun, two gloo ranks on the CPU,
    a 64² googlenet_bn: every check holds (its collectives, ranks' bits,
    ring vs dense, the first loss vs one process, ``train --mesh 2``
    with a snapshot) and rank 0's record says so."""
    import json
    import subprocess
    import sys

    out = tmp_path / "out.json"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "npairloss_tpu_torch.parallel.meshcheck",
         "--device", "cpu", "--size", "64", "--ids", "8", "--steps", "2",
         "--work", str(tmp_path / "work"), "--out", str(out)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["fails"] == [] and rec["world"] == 2
    assert rec["backend"] == "gloo"
    assert all(v is True or isinstance(v, float)
               for v in rec["collectives"].values())
    for engine in ("dense", "ring"):
        assert rec["training"][engine]["ranks_bit_equal_every_step"]
    assert rec["cli"]["rc"] == 0 and rec["cli"]["plan"]["devices"] == 2
    assert rec["cli"]["snapshots"]
    # The synced BatchNorm's sums were timed: two a layer and step.
    ms = rec["collective_ms"]
    assert ms["bn_sums"] == 2 * len(rec["training"]["bn_features"]) > 0
    assert ms["bn_all_reduce_ms"] > 0 and ms["bn_sums_ms"] > 0
