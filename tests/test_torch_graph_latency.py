"""The graph latency tool (npairloss_tpu_torch/tools/graph_latency.py)
times kernels on the card only: without one it says so and fails, and
it measures nothing on the CPU."""

import torch

from npairloss_tpu_torch.tools import graph_latency


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert graph_latency.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().out
