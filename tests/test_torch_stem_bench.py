"""The stem kernel bench (npairloss_tpu_torch/tools/stem_bench.py) times
kernels on the card only: without one it says so and fails.  Its source
variants are checked in tests/test_torch_kernel_breakdown.py."""

import torch

from npairloss_tpu_torch.tools import stem_bench


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stem_bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().out
