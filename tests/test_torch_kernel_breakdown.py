"""The kernel breakdown tool (npairloss_tpu_torch/tools/kernel_breakdown.py)
times variants of csrc/npair_blockwise.cu with one part of the work
removed by a text edit, and builds the variants of csrc/stem.cu that
tools/stem_bench.py times.  Their timings come from the card; here each
edit must still apply exactly once to its source, so the tools fail
loudly, not silently, when the kernels change under them; and the
breakdown's arguments (each precision's variants, a parent checkout's
source, an older parent's grad entry) are handled as its run needs."""

import types

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


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_default_variants_are_the_precisions_own(precision):
    args = kb.parse_args(["--precision", precision])
    names = args.variants.split(",")
    assert names[0] == "full" and len(names) > 1
    assert all(n.startswith("tc_") == (precision == "default")
               for n in names[1:])
    assert set(names) <= set(kb.VARIANTS["npair_blockwise.cu"])
    assert args.parent is None


@pytest.mark.parametrize("argv", [["--precision", "fp16"],
                                  ["--sizes", "32768"],
                                  ["--sizes", "32768x512,8kx1"]])
def test_bad_arguments_exit_2(argv, capsys):
    with pytest.raises(SystemExit) as e:
        kb.parse_args(argv)
    assert e.value.code == 2


def test_parent_source_is_read_from_its_checkout(tmp_path):
    csrc = tmp_path / "npairloss_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "npair_blockwise.cu").write_text("// the parent's kernels\n")
    args = kb.parse_args(["--precision", "default", "--parent",
                          str(tmp_path), "--variants", "full"])
    srcs = kb.sources(args)
    assert list(srcs) == ["full", "parent"]
    assert srcs["parent"] == ("// the parent's kernels\n", csrc)
    assert srcs["full"][0] == (_build.CSRC / "npair_blockwise.cu").read_text()
    with pytest.raises(SystemExit, match="no npair_blockwise.cu"):
        kb.sources(kb.parse_args(["--parent", str(tmp_path / "none")]))


def test_an_older_parent_takes_its_grad_flag():
    """A parent from before the tensor-core gq/gdb takes a bf16 flag where
    this tree's entry takes the product's bf16 rows and their stride;
    this tree's source is not taken for such a parent."""
    src = (_build.CSRC / "npair_blockwise.cu").read_text()
    assert kb._PARENT_GRAD_CALL not in src
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(npl_npair_grad=entry)
    kb._grad_behind(lib)
    head = tuple(range(23))
    assert lib.npl_npair_grad(*head, 1234, 72, "stream") == 0
    assert lib.npl_npair_grad(*head, None, 0, "stream") == 0
    assert calls == [head + (1, "stream"), head + (0, "stream")]
    assert len(entry.argtypes) == len(head) + 2
