"""The kernel breakdown tool (npairloss_tpu_torch/tools/kernel_breakdown.py)
times variants of csrc/npair_blockwise.cu with one part of the work
removed by a text edit, and builds the variants of csrc/stem.cu that
tools/stem_bench.py times.  Their timings come from the card; here each
edit must still apply exactly once to its source, so the tools fail
loudly, not silently, when the kernels change under them."""

import pytest

from npairloss_tpu_torch.ops import _build
from npairloss_tpu_torch.tools import kernel_breakdown as kb


@pytest.mark.parametrize("name", sorted(kb.VARIANTS["npair_blockwise.cu"]))
def test_every_variant_edit_applies_once(name):
    src = (_build.CSRC / "npair_blockwise.cu").read_text()
    what, edits = kb.VARIANTS["npair_blockwise.cu"][name]
    assert what
    for old, new in edits:
        assert src.count(old) == 1, (name, old)
        assert old != new


@pytest.mark.parametrize("name", sorted(kb.VARIANTS["stem.cu"]))
def test_every_stem_variant_edit_applies_once(name):
    src = (_build.CSRC / "stem.cu").read_text()
    what, edits = kb.VARIANTS["stem.cu"][name]
    assert what
    for old, new in edits:
        assert src.count(old) == 1, (name, old)
        assert old != new
    text, include = kb.edited("stem.cu", name)
    assert include == _build.CSRC
    assert (text == src) == (not edits)


@pytest.mark.parametrize("name", sorted(kb.VARIANTS["ivf_probe.cu"]))
def test_every_probe_variant_edit_applies_once(name):
    src = (_build.CSRC / "ivf_probe.cu").read_text()
    what, edits = kb.VARIANTS["ivf_probe.cu"][name]
    assert what
    for old, new in edits:
        assert src.count(old) == 1, (name, old)
        assert old != new
    text, include = kb.edited("ivf_probe.cu", name)
    assert include == _build.CSRC
    assert (text == src) == (not edits)
