"""The port's invariant linter (``npairloss_tpu_torch/analysis``) held
against the JAX package's suite, on the CPU.

  * the pass vocabulary and the option parsers equal JAX's;
  * ``locks`` and ``markers`` give JAX's findings on JAX's fixture trees
    (``tests/fixtures/staticcheck``, copied into ``tmp_path`` with the
    package directory and the timing history mapped to the port's);
  * seeded port trees give their one finding each, with its key, and
    the clean tree none: torch in a declared contract module, a
    ``dist.all_reduce`` outside ``count.collective``, a guarded
    attribute written without its lock, a schema constant defined
    twice, a fired failpoint absent from the RESILIENCE table, a README
    port command with an unknown flag, and an unmarked test of 10 s;
  * the report is accepted by JAX's validator (loaded by file path),
    and a tampered one is refused by both;
  * ``--diff``, a bad allowlist and ``--update-timings`` behave as
    JAX's do;
  * the port's own tree is clean outside its allowlist.
"""

import argparse
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import textwrap

import pytest

from npairloss_tpu import analysis as janalysis
from npairloss_tpu.analysis import runner as jrunner
from npairloss_tpu_torch.analysis import (
    PASS_NAMES,
    run_suite,
    validate_staticcheck_report,
)
from npairloss_tpu_torch.analysis import markers as pmarkers
from npairloss_tpu_torch.analysis import runner as prunner

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "staticcheck"
PKG = "npairloss_tpu_torch"


def _load_by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, str(REPO / rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_REPORT = _load_by_path("_jax_staticcheck_report",
                           "npairloss_tpu/analysis/report.py")


def _keys(report, pass_name=None):
    return sorted(rec["key"] for rec in report["findings"]
                  if pass_name is None or rec["pass"] == pass_name)


def _write_tree(root, files):
    for rel, content in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(textwrap.dedent(content))
    return str(root)


# -- vocabulary and parsers ---------------------------------------------------


def test_pass_vocabulary_pinned():
    from npairloss_tpu import cli as jcli

    from npairloss_tpu_torch import cli

    assert tuple(cli._STATICCHECK_PASSES) == tuple(PASS_NAMES)
    assert tuple(PASS_NAMES) == tuple(janalysis.PASS_NAMES)
    assert tuple(cli._STATICCHECK_PASSES) == tuple(jcli._STATICCHECK_PASSES)


def _options(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[a.dest] = (tuple(a.option_strings),
                       tuple(a.choices) if a.choices else None, a.default,
                       a.type, a.nargs)
    return out


def test_option_parsers_equal_jax():
    """The port's cli subcommand, its runner's own parser and JAX's cli
    subcommand: one option vocabulary."""
    from npairloss_tpu import cli as jcli

    from npairloss_tpu_torch import cli

    mine, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    cli._add_staticcheck_options(mine)
    jcli._add_staticcheck_options(theirs)
    assert _options(mine) == _options(theirs)
    assert _options(prunner._build_parser()) == _options(mine)


# -- locks and markers on JAX's fixture trees ---------------------------------


def _mapped_fixture(name, dst):
    """A copy of JAX's fixture tree with the package directory renamed
    to the port's and the timing history moved to the port's path."""
    shutil.copytree(FIXTURES / name, dst)
    if (dst / "npairloss_tpu").exists():
        (dst / "npairloss_tpu").rename(dst / PKG)
    hist = dst / "tests" / "timing_history.json"
    if hist.exists():
        target = dst / pmarkers.HISTORY_PATH
        target.parent.mkdir(parents=True, exist_ok=True)
        hist.rename(target)
    return str(dst)


def _mapped(rec):
    rec = dict(rec)
    for key in ("path", "key"):
        rec[key] = rec[key].replace("npairloss_tpu/", PKG + "/")
    return rec


@pytest.mark.parametrize("name", ["clean", "unguarded_mutation",
                                  "unmarked_slow"])
def test_locks_and_markers_equal_jax_on_its_fixtures(name, tmp_path):
    passes = ["locks", "markers"]
    theirs = janalysis.run_suite(str(FIXTURES / name), passes=passes)
    mine = run_suite(_mapped_fixture(name, tmp_path / name), passes=passes)
    # The same findings; the markers message names the port's remedy (a
    # smoke run, where JAX's names its ci.sh).
    assert [dict(r, message=r["message"] if r["pass"] == "locks" else "")
            for r in mine["findings"]] == \
        [dict(_mapped(r), message=r["message"] if r["pass"] == "locks"
              else "") for r in theirs["findings"]]
    assert [(p["name"], p["findings"], p["skipped"])
            for p in mine["passes"]] == \
        [(p["name"], p["findings"], p["skipped"]) for p in theirs["passes"]]
    if name != "clean":
        assert mine["findings"]


# -- seeded port trees ----------------------------------------------------------

CLEAN = {
    PKG + "/gameday/verdict.py": """\
        import json

        GAMEDAY_SCHEMA = "npairloss-gameday-v1"


        def validate_gameday_report(report):
            return None if report.get("schema") == GAMEDAY_SCHEMA else "bad"
    """,
    PKG + "/parallel/mesh.py": """\
        import torch.distributed as dist

        from npairloss_tpu_torch.obs.perf import count


        def all_reduce(t, group):
            with count.collective(lambda: 4, op="all_reduce_sum"):
                dist.all_reduce(t, group=group)
            dist.barrier(group=group)
            return t
    """,
    PKG + "/serve/reg.py": """\
        import threading


        class Registry:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = {}  # guarded-by: _lock

            def put(self, k, v):
                with self._lock:
                    self._items[k] = v
    """,
    PKG + "/serve/engine.py": """\
        from npairloss_tpu_torch.resilience import failpoints


        def dispatch():
            if failpoints.should_fire("serve.latency"):
                return 1
            return 0
    """,
    PKG + "/cli.py": """\
        import argparse


        def build_parser():
            p = argparse.ArgumentParser()
            sub = p.add_subparsers()
            sv = sub.add_parser("serve")
            sv.add_argument("--replicas", type=int)
            return p
    """,
    "docs/RESILIENCE.md": """\
        | failpoint | injects |
        |---|---|
        | `serve.latency` | a stall |
    """,
    "README.md": """\
        # Port

        ```bash
        python -m npairloss_tpu_torch serve --replicas 2
        ```

        Or `python -m npairloss_tpu_torch serve
        --replicas 2` inline.
    """,
    "tests/test_torch_x.py": """\
        def test_fast():
            assert True


        def test_heavy():  # slow-ok: holds the path nothing else covers
            assert True
    """,
    pmarkers.HISTORY_PATH: json.dumps({
        "threshold_s": 10.0,
        "durations": {"tests/test_torch_x.py::test_fast": 0.5,
                      "tests/test_torch_x.py::test_heavy": 30.0}}),
}
CLEAN = {rel: textwrap.dedent(text) for rel, text in CLEAN.items()}

SEEDED = {
    "torch_in_contract": (
        {PKG + "/gameday/verdict.py": CLEAN[PKG + "/gameday/verdict.py"]
         .replace("import json\n", "import json\n\nimport torch\n")},
        ["purity:npairloss_tpu_torch/gameday/verdict.py:reaches-torch"]),
    "uncounted_collective": (
        {PKG + "/parallel/ring.py": """\
            import torch.distributed as dist


            def hop(t, group):
                dist.all_reduce(t, group=group)
        """},
        ["scopes:npairloss_tpu_torch/parallel/ring.py:all_reduce"]),
    "unguarded_write": (
        {PKG + "/serve/reg.py": CLEAN[PKG + "/serve/reg.py"] + "\n"
         "    def reset(self):\n"
         "        self._items = {}\n"},
        ["locks:npairloss_tpu_torch/serve/reg.py:Registry.reset._items"]),
    "schema_twice": (
        {PKG + "/serve/manifest.py": """\
            GAMEDAY_SCHEMA = "npairloss-gameday-v1"


            def validate_manifest(m):
                return None
        """},
        ["contracts:npairloss_tpu_torch/gameday/verdict.py:"
         "npairloss-gameday-v1",
         "contracts:npairloss_tpu_torch/serve/manifest.py:"
         "npairloss-gameday-v1"]),
    "undocumented_failpoint": (
        {PKG + "/serve/batcher.py": """\
            from npairloss_tpu_torch.resilience import failpoints


            def stall():
                failpoints.fire("serve.bogus")
        """},
        ["vocab:npairloss_tpu_torch/serve/batcher.py:failpoint-serve.bogus"]),
    "unknown_flag": (
        {"README.md": CLEAN["README.md"].replace(
            "--replicas 2\n```", "--replicas 2 --no-such-flag\n```")},
        ["vocab:README.md:flag---no-such-flag"]),
    "unmarked_slow": (
        {"tests/test_torch_x.py": CLEAN["tests/test_torch_x.py"].replace(
            "def test_fast():", "def test_fast():  # 10 s now")},
        ["markers:tests/test_torch_x.py:test_fast"]),
}


def _seeded_history(name):
    if name != "unmarked_slow":
        return {}
    hist = json.loads(CLEAN[pmarkers.HISTORY_PATH])
    hist["durations"]["tests/test_torch_x.py::test_fast"] = 10.0
    return {pmarkers.HISTORY_PATH: json.dumps(hist)}


def test_clean_port_tree_has_no_finding(tmp_path):
    report = run_suite(_write_tree(tmp_path, CLEAN))
    assert report["findings"] == [] and report["allowlisted"] == []
    assert all(not p["skipped"] for p in report["passes"])
    assert validate_staticcheck_report(report) is None


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_port_tree_flagged_with_its_key(name, tmp_path):
    files, keys = SEEDED[name]
    tree = dict(CLEAN, **files, **_seeded_history(name))
    report = run_suite(_write_tree(tmp_path, tree))
    assert _keys(report) == sorted(keys)
    assert validate_staticcheck_report(report) is None
    assert JAX_REPORT.validate_staticcheck_report(report) is None


def test_inline_span_in_a_fence_is_not_a_command(tmp_path):
    readme = CLEAN["README.md"] + textwrap.dedent("""\
        ```bash
        echo `python -m npairloss_tpu_torch serve --fenced-only`
        ```
    """)
    report = run_suite(_write_tree(tmp_path, dict(CLEAN, **{
        "README.md": readme})))
    assert _keys(report) == ["vocab:README.md:flag---fenced-only"]


# -- the report contract ------------------------------------------------------


def _tampered(report):
    def broken(mutate):
        rep = json.loads(json.dumps(report))
        mutate(rep)
        return rep

    return {
        "schema": broken(lambda r: r.update(
            schema="npairloss-staticcheck-v2")),
        "no_summary": broken(lambda r: r.pop("summary")),
        "message": broken(lambda r: r["findings"][0].pop("message")),
        "ghost_pass": broken(lambda r: r["findings"][0].update(
            {"pass": "ghost"})),
        "key": broken(lambda r: r["findings"][0].update(key="wrong")),
        "claims": broken(lambda r: r["passes"][1].update(findings=99)),
        "summary": broken(lambda r: r["summary"].update(findings=0)),
        "duplicate": broken(lambda r: r["passes"].append(
            dict(r["passes"][0]))),
        "no_passes": broken(lambda r: r.update(passes=[])),
    }


def test_report_accepted_by_jax_and_tampering_refused_by_both(tmp_path):
    files, _ = SEEDED["uncounted_collective"]
    report = run_suite(_write_tree(tmp_path, dict(CLEAN, **files)))
    assert report["schema"] == janalysis.STATICCHECK_SCHEMA
    assert JAX_REPORT.validate_staticcheck_report(report) is None
    for what, bad in _tampered(report).items():
        mine = validate_staticcheck_report(bad)
        assert mine is not None, what
        assert mine == JAX_REPORT.validate_staticcheck_report(bad), what


# -- --diff, the allowlist, --update-timings ----------------------------------


def _git(cwd, *args):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    *args], cwd=cwd, check=True, capture_output=True)


def _diff_tree(root, pkg):
    files = {f"{pkg}/old.py": """\
        import threading


        class Old:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: _lock

            def bump(self):
                self.n += 1
    """}
    _write_tree(root, files)
    _git(str(root), "init", "-q")
    _git(str(root), "add", "-A")
    _git(str(root), "commit", "-qm", "base")
    _write_tree(root, {f"{pkg}/new.py": files[f"{pkg}/old.py"]
                       .replace("Old", "New")})
    return str(root)


def test_diff_mode_restricts_as_jax(tmp_path):
    mine = _diff_tree(tmp_path / "p", PKG)
    theirs = _diff_tree(tmp_path / "j", "npairloss_tpu")
    for diff in (None, "HEAD"):
        got = run_suite(mine, passes=["locks"], diff_base=diff)
        want = janalysis.run_suite(theirs, passes=["locks"],
                                   diff_base=diff)
        assert got["findings"] == [_mapped(r) for r in want["findings"]]
    assert len(_keys(run_suite(mine, passes=["locks"]))) == 2
    assert _keys(run_suite(mine, passes=["locks"], diff_base="HEAD")) == [
        "locks:npairloss_tpu_torch/new.py:New.bump.n"]
    assert prunner.changed_files(mine, "HEAD") == [PKG + "/new.py"]
    with pytest.raises(ValueError):
        run_suite(str(tmp_path), diff_base="no-such-ref")


@pytest.mark.parametrize("allow", ['{"allow": [42]}', '{"allow": {}}',
                                   "[1, 2]", "not json"])
def test_bad_allowlist_is_loud_as_jax(allow, tmp_path):
    path = tmp_path / "allow.json"
    path.write_text(allow)
    root = _write_tree(tmp_path / "tree", CLEAN)
    with pytest.raises(ValueError) as mine:
        run_suite(root, allowlist_path=str(path))
    with pytest.raises(ValueError) as theirs:
        janalysis.run_suite(root, allowlist_path=str(path))
    assert str(mine.value) == str(theirs.value)


def test_allowlist_tolerates_the_named_finding(tmp_path):
    files, keys = SEEDED["uncounted_collective"]
    root = _write_tree(tmp_path / "tree", dict(CLEAN, **files))
    allow = tmp_path / "allow.json"
    allow.write_text(json.dumps({"allow": [{"key": keys[0],
                                            "why": "a test"}]}))
    report = run_suite(root, allowlist_path=str(allow))
    assert report["findings"] == []
    assert [r["key"] for r in report["allowlisted"]] == keys
    assert validate_staticcheck_report(report) is None


def test_update_timings_as_jax(tmp_path):
    log = tmp_path / "t1.log"
    log.write_text("12.34s call     tests/test_torch_x.py::test_fast\n"
                   "0.50s setup    tests/test_torch_x.py::test_fast\n"
                   "3.21s call     tests/test_torch_x.py::test_heavy[a]\n")
    (tmp_path / "j" / "tests").mkdir(parents=True)
    mine = prunner.update_timings(str(tmp_path / "p"), str(log), 10.0)
    theirs = jrunner.update_timings(str(tmp_path / "j"), str(log), 10.0)
    assert mine == str(tmp_path / "p" / pmarkers.HISTORY_PATH)
    assert pathlib.Path(mine).read_text() == \
        pathlib.Path(theirs).read_text()
    _write_tree(tmp_path / "p", {"tests/test_torch_x.py":
                                 CLEAN["tests/test_torch_x.py"]})
    assert _keys(run_suite(str(tmp_path / "p"), passes=["markers"])) == [
        "markers:tests/test_torch_x.py:test_fast"]
    empty = tmp_path / "empty.log"
    empty.write_text("no durations\n")
    for runner in (prunner, jrunner):
        with pytest.raises(ValueError):
            runner.update_timings(str(tmp_path / "p"), str(empty), 10.0)


def test_cli_update_timings_and_bad_root_exit_codes(tmp_path, capsys):
    from npairloss_tpu_torch import cli

    log = tmp_path / "t1.log"
    log.write_text("1.00s call tests/test_torch_x.py::test_fast\n")
    root = str(tmp_path / "tree")
    assert cli.main(["staticcheck", root, "--update-timings",
                     str(log)]) == 0
    assert os.path.exists(os.path.join(root, pmarkers.HISTORY_PATH))
    assert cli.main(["staticcheck", root, "--update-timings",
                     str(tmp_path / "missing.log")]) == 2
    assert cli.main(["staticcheck", root, "--diff", "no-such-ref",
                     "--out", "-"]) == 2
    _write_tree(tmp_path / "bad", dict(CLEAN, **SEEDED["unknown_flag"][0]))
    out = tmp_path / "r.json"
    assert cli.main(["staticcheck", str(tmp_path / "bad"), "--out",
                     str(out)]) == 1
    assert JAX_REPORT.validate_staticcheck_report(
        json.loads(out.read_text())) is None
    capsys.readouterr()


# -- the port's own tree --------------------------------------------------------


def test_port_tree_is_clean():
    """The port's gate: zero findings outside its allowlist on the repo
    (the contracts pass among them: one definition of
    npairloss-snapshot-v1; the vocab pass: cli._PROBE_IMPL_CHOICES
    pinned to the probe's registry)."""
    report = run_suite(str(REPO))
    assert report["findings"] == [], [r["message"]
                                      for r in report["findings"]]
    assert all(not p["skipped"] for p in report["passes"])
    assert validate_staticcheck_report(report) is None
    assert JAX_REPORT.validate_staticcheck_report(report) is None
    allow = json.loads((REPO / prunner.ALLOWLIST_PATH).read_text())
    for entry in allow["allow"]:
        assert isinstance(entry, dict) and entry.get("why"), entry
