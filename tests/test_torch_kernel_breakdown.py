"""The kernel breakdown tool (npairloss_tpu_torch/tools/kernel_breakdown.py)
times variants of csrc/npair_blockwise.cu with one part of the work
removed by a text edit, and builds the variants of csrc/stem.cu that
tools/stem_bench.py times.  Their timings come from the card; here each
edit must still apply exactly once to its source, so the tools fail
loudly, not silently, when the kernels change under them; and the
breakdown's arguments (each precision's variants, a parent checkout's
source, a parent's older entries) are handled as its run needs."""

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


def test_a_parent_before_the_tensor_core_sim_tile_is_bound_behind():
    """A parent whose stats, hist and loss entries take no bf16 rows and
    whose grad entry takes the product's rows alone is called through
    this tree's calls (..., feats16, pool16, ld16, stream): the sweeps
    drop the rows, gq passes pool16 and gdb feats16; this tree's source
    is not taken for such a parent."""
    src = (_build.CSRC / "npair_blockwise.cu").read_text()
    assert kb._PARENT_SWEEP_CALL not in src
    calls = {}

    def entry(name):
        def fn(*args):
            calls.setdefault(name, []).append(args)
            return 0
        return fn

    names = ("npl_npair_stats", "npl_npair_hist", "npl_npair_loss",
             "npl_npair_grad")
    lib = types.SimpleNamespace(**{n: entry(n) for n in names})
    raw = {n: getattr(lib, n) for n in names}
    kb._sweeps_behind(lib)
    for name in names[:3]:
        sig = _build._SIGNATURES[name]
        head = tuple(range(len(sig) - 4))
        assert getattr(lib, name)(*head, "f16", "p16", 72, "stream") == 0
        assert calls[name] == [head + ("stream",)]
        assert len(raw[name].argtypes) == len(sig) - 3
    sig = _build._SIGNATURES["npl_npair_grad"]
    head = tuple(range(len(sig) - 6))
    for pool_major, want in ((0, "p16"), (1, "f16")):
        assert lib.npl_npair_grad(*head, pool_major, "out", "f16", "p16", 72,
                                  "stream") == 0
        assert calls["npl_npair_grad"][-1] == head + (
            pool_major, "out", want, 72, "stream")
    assert len(raw["npl_npair_grad"].argtypes) == len(sig) - 1
