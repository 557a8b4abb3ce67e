"""``tools/phase_times.py``: chip_smoke's log split into phase seconds."""

import json

import pytest

from npairloss_tpu_torch.tools import phase_times as pt


@pytest.mark.parametrize("tag,phase", [
    ("card", "start"), ("path", "4"), ("5i", "5i"), ("7a", "7"),
    ("8e", "8"), ("9", "9"), ("10", "10"), ("10a", "10"), ("10b", "10"),
    ("11a", "11"), ("12", "12"), ("12e", "12"), ("13", "13"),
    ("13d", "13"), ("mem", None),
    ("profile", None), ("kernel", "3"),
    ("zzz", None)])
def test_phase_of_tags(tag, phase):
    assert pt.phase_of(tag) == phase


def test_split_charges_each_gap_to_its_line_and_never_moves_back():
    stamped = [(1.0, "[card] H100"), (3.0, "[build] ok"),
               (4.0, "[index] built"), (10.0, "[kernel] lrn"),
               (11.0, "[path] served"), (12.0, "warning: untagged"),
               (20.0, "[profile] top ops"), (21.0, "[5h] ok"),
               (24.0, "[bn-train] late line"), (30.0, "[8a] telemetry"),
               (31.0, "[done] 31 s")]
    got = pt.split(stamped)
    assert got == {"start": 3.0, "3": 7.0, "4": 10.0, "5h": 4.0,
                   "8": 6.0, "done": 1.0}
    assert sum(got.values()) == stamped[-1][0]


def test_run_tree_stamps_a_tree_and_writes_its_log(tmp_path):
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "chip_smoke.py").write_text(
        "print('[card] x')\nprint('[path] y')\n"
        "print('[done] z')\nraise SystemExit(3)\n")
    out, logs = tmp_path / "out.jsonl", tmp_path / "logs"
    rc = pt.main(["--tree", str(tree), "--out", str(out),
                  "--logs", str(logs)])
    assert rc == 1
    rec = json.loads(out.read_text())
    assert rec["rc"] == 3 and rec["last_line"] == "[done] z"
    assert set(rec["phases"]) == {"start", "4", "done"}
    log = (logs / "run0_tree.log").read_text().splitlines()
    assert [ln.split(None, 1)[1] for ln in log] == [
        "[card] x", "[path] y", "[done] z"]
