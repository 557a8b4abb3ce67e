"""The slice end to end on the CPU: ``train`` through both CLIs on a PPM
list file (the tiny MLP net, an identity transform: 8 x 8 images, crop 8,
no mirror), without ``--synthetic``.

Tolerance: the JAX CLI shards its batch over the 8 test devices, so the
values differ; the event streams (events, iterations, keys and their
order), the final line's keys and the display lines with their numbers
masked out are equal.
"""

import io
import json
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

from npairloss_tpu import cli as jax_cli
from npairloss_tpu_torch import cli

from test_torch_data import write_ppm_list

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mask(line):
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)


def list_file_solver(tmp_path):
    """The tiny net and solver with both data layers on a PPM list file
    under tmp_path (8 identities x 3 images, resized to 8 x 8), a display
    and TEST every 2 iterations."""
    root = tmp_path / "images"
    root.mkdir()
    src = write_ppm_list(root, n_ids=8, per_id=3)
    net = open(os.path.join(REPO, "examples", "tiny_net.prototxt")).read()
    net = net.replace(
        "multi_batch_data_param {",
        f'multi_batch_data_param {{\n        root_folder: "{root}/"\n'
        f'        source: "{src}"\n        new_height: 8\n'
        "        new_width: 8")
    assert net.count(src) == 2
    (tmp_path / "net.prototxt").write_text(net)
    solver = open(os.path.join(REPO, "examples", "tiny_solver.prototxt")
                  ).read()
    for key, val in (("display", 2), ("test_interval", 2), ("test_iter", 1)):
        solver, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {val}", solver)
        assert n == 1
    solver = solver.replace('net: "examples/tiny_net.prototxt"',
                            f'net: "{tmp_path / "net.prototxt"}"')
    path = tmp_path / "solver.prototxt"
    path.write_text(solver)
    return str(path)


@pytest.mark.parametrize("native", ["never", "require"])
def test_list_file_train_event_stream_matches_jax_cli(tmp_path, native):
    solver = list_file_solver(tmp_path)
    streams, outs = {}, {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(["train", "--solver", solver, "--max_iter", "4",
                       "--native", native, "--log-json", str(path), *extra])
        assert rc == 0
        streams[name] = [json.loads(ln) for ln in path.read_text()
                         .splitlines()]
        outs[name] = buf.getvalue().strip().splitlines()
    key = lambda recs: [(r["event"], r["iteration"], list(r))  # noqa: E731
                        for r in recs]
    assert key(streams["port"]) == key(streams["jax"])
    assert [(e, i) for e, i, _ in key(streams["port"])] == [
        ("display", 2), ("test", 2), ("display", 4), ("test", 4)]
    assert list(json.loads(outs["port"][-1])) == list(
        json.loads(outs["jax"][-1]))
    display = lambda lines: [_mask(ln) for ln in lines  # noqa: E731
                             if ln.startswith("iter ")]
    assert display(outs["port"]) == display(outs["jax"])
    for rec in streams["port"]:
        assert all(np.isfinite(v) for v in rec.values()
                   if isinstance(v, float))
