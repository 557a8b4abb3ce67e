"""The stem kernel bench (npairloss_tpu_torch/tools/stem_bench.py) times
kernels on the card only: without one it says so and fails.  Its source
variants are checked in tests/test_torch_kernel_breakdown.py."""

import torch

from npairloss_tpu_torch.tools import stem_bench


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stem_bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().out


def test_bias_relu_rows_cover_the_path_shapes():
    """The four bias+ReLU cases are the path's: both sites of a batch-120
    fp32 training step and of a 32-image bf16 encode."""
    assert stem_bench.BIAS_RELU_CASES == (
        ((120, 56, 56, 64), "fp32"), ((120, 56, 56, 192), "fp32"),
        ((32, 56, 56, 64), "bf16"), ((32, 56, 56, 192), "bf16"))


def test_bias_relu_row_schema_and_bound():
    """A row carries each library's time and its share of the byte bound
    (x read and out written once, the fp32 bias once, over 3.35 TB/s)."""
    row = stem_bench.bias_relu_row((120, 56, 56, 64), "fp32",
                                   {"ms_full": 0.1, "ms_parent": 0.2}, 0.3)
    n = 120 * 56 * 56 * 64
    bound = (8 * n + 4 * 64) / 3.35e12 * 1e3
    assert list(row) == ["kernel", "shape", "dtype", "bound_ms", "ms_full",
                         "ms_parent", "share_full", "share_parent",
                         "relu_add_yardstick_ms"]
    assert row["kernel"] == "bias_relu" and row["dtype"] == "fp32"
    assert row["shape"] == [120, 56, 56, 64]
    assert abs(row["bound_ms"] - bound) < 1e-12
    assert abs(row["bound_ms"] - 0.0575) < 1e-4  # PERF.md row 10's bound
    assert abs(row["share_full"] - bound / 0.1) < 1e-12
    assert abs(row["share_parent"] - bound / 0.2) < 1e-12
    bf16 = stem_bench.bias_relu_row((32, 56, 56, 192), "bf16",
                                    {"ms_full": 0.05}, None)
    assert abs(bf16["bound_ms"] - 0.0230) < 1e-4
