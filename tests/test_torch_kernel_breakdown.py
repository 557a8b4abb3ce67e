"""The kernel breakdown tool (npairloss_tpu_torch/tools/kernel_breakdown.py)
times variants of csrc/npair_blockwise.cu with one part of the work
removed by a text edit.  Its timings come from the card; here each edit
must still apply exactly once to the source, so the tool fails loudly,
not silently, when the kernels change under it."""

import pytest

from npairloss_tpu_torch.ops import _build
from npairloss_tpu_torch.tools import kernel_breakdown as kb


@pytest.mark.parametrize("name", sorted(kb.VARIANTS))
def test_every_variant_edit_applies_once(name):
    src = (_build.CSRC / "npair_blockwise.cu").read_text()
    what, edits = kb.VARIANTS[name]
    assert what
    for old, new in edits:
        assert src.count(old) == 1, (name, old)
        assert old != new
