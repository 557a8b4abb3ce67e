"""The probe bench (npairloss_tpu_torch/tools/probe_bench.py) times the
IVF probe kernel on the card only: without one it says so and fails.
Its source variants are checked in tests/test_torch_kernel_breakdown.py;
its gallery is chip_smoke.py's."""

import numpy as np
import torch

from npairloss_tpu_torch.tools import probe_bench


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().out


def test_gallery_is_unit_rows_in_identities():
    emb, labels = probe_bench.synthetic_gallery(0, n=60, ids=11, dim=16)
    assert emb.shape == (60, 16) and emb.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-6)
    counts = np.bincount(labels)
    assert counts.sum() == 60 and counts.min() >= 5 and len(counts) == 11
