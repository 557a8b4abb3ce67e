"""End-to-end real-image training through the port's CLI — the twin of
``scripts/e2e_real_jpeg.py``, whose workflow it repeats with the port:

    on-disk JPEG dataset -> tools/make_list.py list files (zero-shot
      class split) -> net/solver prototxts
      -> ``python -m npairloss_tpu_torch train`` (the list-file
         MultibatchData path: JPEG decode, identity-balanced sampling,
         crop/mirror augmentation) -> snapshot
      -> a SECOND train run resuming from the mid-run snapshot
      -> ``extract`` of the held-out classes from the final snapshot
      -> ``eval`` (full-gallery Recall@K and NMI over classes the model
         never saw).

The dataset is the JAX script's (:func:`make_dataset`: each identity a
smooth random colour pattern, each instance a jittered copy; the conv
trunks get :func:`make_dataset_structural`).  ``--weights`` starts the
trunk from a given weights file (the port's ``.npz``), so a run can
start from the same numbers as a JAX run given the same tree as
msgpack.  Every step is a subprocess of the port's CLI on ``--device``
(default the card; ``--device cpu`` on the CPU).  ``--native require``
decodes with the native runtime's libjpeg; on a machine without
libjpeg, ``--native never`` decodes with PIL.  The record
goes to ``<workdir>/e2e_real_jpeg.json``; the exit code is nonzero when
a bar is missed.

Usage: python -m npairloss_tpu_torch.tools.e2e_real_jpeg --workdir DIR
           [--steps 400] [--model mlp] [--weights W.npz] [--device cpu]
           [--native never]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

IDS = 20            # total classes on disk
TRAIN_CLASSES = 16  # the first 16 train; the last 4 are zero-shot classes
PER_ID = 8
SIDE = 64
CROP = 56


def make_dataset(root: str, rng: np.random.Generator, side: int = SIDE):
    """IDS identities x PER_ID JPEGs in one class-per-directory tree: a
    smooth low-frequency RGB pattern per identity (upsampled 4x4 noise),
    instances with brightness jitter, pixel noise and a large
    translation (the JAX script's generator, with the side a
    parameter)."""
    from PIL import Image

    for cid in range(IDS):
        base_rng = np.random.default_rng(1000 + cid)
        coarse = base_rng.uniform(40, 215, size=(4, 4, 3))
        base = np.kron(coarse, np.ones((side // 4, side // 4, 1)))
        cdir = os.path.join(root, f"id_{cid:03d}")
        os.makedirs(cdir, exist_ok=True)
        for k in range(PER_ID):
            inst = base + rng.normal(0, 45, size=base.shape)
            inst = (inst - 128) * rng.uniform(0.6, 1.4) + 128
            inst = inst + rng.uniform(-30, 30)
            dx, dy = rng.integers(-8, 9, size=2)
            inst = np.roll(inst, (dy, dx), axis=(0, 1))
            img = np.clip(inst, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(cdir, f"img_{k:02d}.jpg"), quality=92)


def make_dataset_structural(root: str, rng: np.random.Generator,
                            side: int = SIDE):
    """The conv-trunk dataset: identity in spatial structure only (a
    fixed binary blob mask per class, both hues re-drawn per instance),
    so colour statistics carry ~no class signal (the JAX script's)."""
    from PIL import Image

    for cid in range(IDS):
        base_rng = np.random.default_rng(2000 + cid)
        coarse = base_rng.standard_normal((6, 6))
        up = np.kron(coarse, np.ones((side // 6 + 1, side // 6 + 1)))
        mask = (up[:side, :side] > 0).astype(np.float64)[..., None]
        cdir = os.path.join(root, f"id_{cid:03d}")
        os.makedirs(cdir, exist_ok=True)
        for k in range(PER_ID):
            bg = rng.uniform(30, 120, size=3)
            fg = bg + rng.uniform(60, 110, size=3)
            inst = mask * fg + (1 - mask) * bg
            inst = inst + rng.normal(0, 25, size=inst.shape)
            inst = inst + rng.uniform(-20, 20)
            dx, dy = rng.integers(-8, 9, size=2)
            inst = np.roll(inst, (dy, dx), axis=(0, 1))
            img = np.clip(inst, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(cdir, f"img_{k:02d}.jpg"), quality=92)


NET_TPL = """\
name: "MLP_E2E"
layer {{
    name: "data_mb"
    type: "MultibatchData"
    top: "data_mb"
    top: "label_mb"
    include {{ phase: TRAIN }}
    transform_param {{
        mirror: {mirror}
        crop_size: {crop}
        mean_value: 128
        mean_value: 128
        mean_value: 128
    }}
    multi_batch_data_param {{
        root_folder: "{ws}/images/"
        source: "{ws}/train.txt"
        batch_size: 16
        shuffle: true
        new_height: {side}
        new_width: {side}
        identity_num_per_batch: 8
        img_num_per_identity: 2
        rand_identity: true
    }}
}}
layer {{
    name: "data_mb"
    type: "MultibatchData"
    top: "data_mb"
    top: "label_mb"
    include {{ phase: TEST }}
    transform_param {{
        crop_size: {crop}
        mean_value: 128
        mean_value: 128
        mean_value: 128
    }}
    multi_batch_data_param {{
        root_folder: "{ws}/images/"
        source: "{ws}/test.txt"
        batch_size: 16
        new_height: {side}
        new_width: {side}
        identity_num_per_batch: 4
        img_num_per_identity: 4
    }}
}}
layer {{
    name: "norm"
    type: "L2Normalize"
    bottom: "emb"
    top: "emb_norm"
}}
layer {{
    name: "loss"
    type: "NPairMultiClassLoss"
    bottom: "emb_norm"
    bottom: "label_mb"
    top: "loss"
    top: "retrieve_top1"
    npair_loss_param {{
        margin_diff: -0.05
        an_mining_method: HARD
    }}
}}
"""

SOLVER_TPL = """\
net: "{ws}/net.prototxt"
base_lr: {base_lr}
lr_policy: "fixed"
momentum: 0.9
weight_decay: 0.0001
max_iter: {max_iter}
display: {display}
average_loss: {display}
test_iter: 4
test_interval: {test_interval}
test_initialization: true
snapshot: {snapshot}
snapshot_prefix: "{ws}/snap_"
"""

ITER_RE = re.compile(r"^iter (\d+) lr=\S+ loss=(\S+) \(avg over \d+\)(.*)$")
TEST_RE = re.compile(r"^iter (\d+) TEST (.*)$")


def prepare(ws: str, steps: int, base_lr: float, structural: bool = False,
            side: int = SIDE, crop: int = CROP, mirror: bool = True,
            seed: int = 7) -> Dict[str, object]:
    """The JPEG tree, the zero-shot lists (through ``tools/make_list.py
    --split-classes``) and the net/solver prototxts under ``ws``;
    returns the run's geometry."""
    rng = np.random.default_rng(seed)
    (make_dataset_structural if structural else make_dataset)(
        os.path.join(ws, "images"), rng, side)
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_list.py"),
         os.path.join(ws, "images"),
         "--out-train", os.path.join(ws, "train.txt"),
         "--out-test", os.path.join(ws, "test.txt"),
         "--split-classes", str(TRAIN_CLASSES)],
        check=True, cwd=REPO, stdout=subprocess.DEVNULL)
    n_train = sum(1 for _ in open(os.path.join(ws, "train.txt")))
    if n_train != TRAIN_CLASSES * PER_ID:
        raise SystemExit(f"make_list wrote {n_train} train rows, wanted "
                         f"{TRAIN_CLASSES * PER_ID}")
    snapshot_at = steps // 2
    display = max(steps // 20, 1)
    with open(os.path.join(ws, "net.prototxt"), "w") as f:
        f.write(NET_TPL.format(ws=ws, side=side, crop=crop,
                               mirror="true" if mirror else "false"))
    with open(os.path.join(ws, "solver.prototxt"), "w") as f:
        f.write(SOLVER_TPL.format(
            ws=ws, max_iter=steps, display=display, base_lr=base_lr,
            test_interval=max(steps // 4, 1), snapshot=snapshot_at))
    return {"n_train": n_train, "snapshot_at": snapshot_at,
            "display": display, "side": side, "crop": crop,
            "mirror": mirror}


def run_cli(args_list: List[str], log_path: str, device: str) -> str:
    """One port CLI command as a subprocess (its output kept in
    ``log_path``); exits on a nonzero code."""
    cmd = [sys.executable, "-m", "npairloss_tpu_torch"] + args_list \
        + ["--device", device]
    proc = subprocess.run(cmd, cwd=REPO, text=True, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, timeout=3600)
    with open(log_path, "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], file=sys.stderr)
        raise SystemExit(f"CLI failed rc={proc.returncode}: {' '.join(cmd)}")
    return proc.stdout


def _kv(rest: str) -> Dict[str, float]:
    return {k: float(v) for k, v in (
        kv.split("=") for kv in rest.split() if "=" in kv)}


def parse_curve(stdout: str) -> Tuple[list, list, Optional[int]]:
    """(train display rows, TEST rows, the iteration resumed from)."""
    train, test, resumed_from = [], [], None
    for line in stdout.splitlines():
        m = ITER_RE.match(line.strip())
        if m:
            row = {"iter": int(m.group(1)), "loss": float(m.group(2))}
            row.update(_kv(m.group(3)))
            train.append(row)
            continue
        m = TEST_RE.match(line.strip())
        if m:
            row = {"iter": int(m.group(1))}
            row.update(_kv(m.group(2)))
            test.append(row)
            continue
        m = re.match(r"^resuming from iteration (\d+)", line.strip())
        if m:
            resumed_from = int(m.group(1))
    return train, test, resumed_from


def run_chain(ws: str, steps: int, model: str, geometry: Dict[str, object],
              device: str, weights: Optional[str] = None,
              native: str = "require") -> Dict[str, object]:
    """train -> resume from the mid-run snapshot -> extract the
    held-out classes from the final snapshot -> eval; returns the
    curves, the resume evidence and the gallery metrics."""
    solver = os.path.join(ws, "solver.prototxt")
    common = ["--solver", solver, "--model", model, "--native", native]
    out1 = run_cli(["train", *common,
                    *(["--weights", weights] if weights else [])],
                   os.path.join(ws, "train.log"), device)
    train_curve, test_curve, _ = parse_curve(out1)
    snapshot_at = int(geometry["snapshot_at"])
    snap = os.path.join(ws, f"snap_iter_{snapshot_at}.ckpt")
    if not os.path.isdir(snap):
        raise SystemExit(f"snapshot missing: {snap}")
    out2 = run_cli(["train", *common, "--resume", snap],
                   os.path.join(ws, "resume.log"), device)
    r_train, r_test, resumed_from = parse_curve(out2)
    final_snap = os.path.join(ws, f"snap_iter_{steps}.ckpt")
    n_test = (IDS - TRAIN_CLASSES) * PER_ID
    run_cli(["extract", *common, "--phase", "TEST",
             "--batches", str(n_test // 16), "--resume", final_snap,
             "--out", os.path.join(ws, "feats")],
            os.path.join(ws, "extract.log"), device)
    out4 = run_cli(["eval", "--prefix", os.path.join(ws, "feats"),
                    "--ks", "1", "2", "4", "--nmi"],
                   os.path.join(ws, "eval.log"), device)
    return {"train_curve": train_curve, "test_curve": test_curve,
            "resumed_from": resumed_from, "resumed_train_curve": r_train,
            "resumed_test_curve": r_test,
            "gallery": json.loads(out4.strip().splitlines()[-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--model", default="mlp",
                    help="trunk; a conv trunk trains on the structural "
                    "dataset")
    ap.add_argument("--base-lr", type=float, default=None,
                    help="solver base_lr (default 0.03 for mlp, 0.05 for "
                    "conv trunks)")
    ap.add_argument("--weights", default=None,
                    help="initial weights (.npz, a flattened flax tree)")
    ap.add_argument("--side", type=int, default=SIDE)
    ap.add_argument("--crop", type=int, default=CROP)
    ap.add_argument("--no-mirror", dest="mirror", action="store_false")
    ap.add_argument("--native", choices=["auto", "never", "require"],
                    default="require")
    ap.add_argument("--device", default=None,
                    help="device of every CLI step (default: the card)")
    ap.add_argument("--r1-bar", type=float, default=0.9,
                    help="train-batch retrieve_top1 the final model must "
                    "reach (seen classes)")
    ap.add_argument("--unseen-bar", type=float, default=None,
                    help="zero-shot bar on TEST retrieve_top1 and gallery "
                    "R@1 (default 0.7 for mlp, 0.4 for conv trunks)")
    args = ap.parse_args(argv)
    if args.base_lr is None:
        args.base_lr = 0.03 if args.model == "mlp" else 0.05
    if args.unseen_bar is None:
        args.unseen_bar = 0.7 if args.model == "mlp" else 0.4
    from npairloss_tpu_torch.device import resolve_device

    device = str(resolve_device(args.device))
    ws = os.path.abspath(args.workdir)
    shutil.rmtree(ws, ignore_errors=True)
    os.makedirs(ws)
    geometry = prepare(ws, args.steps, args.base_lr,
                       structural=args.model != "mlp", side=args.side,
                       crop=args.crop, mirror=args.mirror)
    print(f"[e2e] {IDS} ids x {PER_ID} JPEGs under {ws}/images; training "
          f"{args.steps} iters via the port's CLI on {device}")
    res = run_chain(ws, args.steps, args.model, geometry, device,
                    weights=args.weights, native=args.native)
    train_curve, test_curve = res["train_curve"], res["test_curve"]
    if not train_curve or not test_curve:
        raise SystemExit("no display or TEST lines parsed from the log")
    display = int(geometry["display"])
    snapshot_at = int(geometry["snapshot_at"])
    first_display = (snapshot_at // display + 1) * display
    r_train, r_test = res["resumed_train_curve"], res["resumed_test_curve"]
    gallery = res["gallery"]
    first_unseen = test_curve[0].get("retrieve_top1", 0.0)
    final_unseen = test_curve[-1].get("retrieve_top1", 0.0)
    resumed_unseen = r_test[-1].get("retrieve_top1", 0.0) if r_test else None
    final_train_r1 = train_curve[-1].get("retrieve_top1", 0.0)
    gallery_r1 = gallery.get("recall_at_1", 0.0)
    ok = (final_train_r1 >= args.r1_bar
          and train_curve[-1]["loss"] < train_curve[0]["loss"]
          and final_unseen >= args.unseen_bar
          and final_unseen > first_unseen
          and res["resumed_from"] == snapshot_at
          and bool(r_train) and r_train[0]["iter"] == first_display
          and (resumed_unseen is None or resumed_unseen >= args.unseen_bar)
          and gallery_r1 >= args.unseen_bar)
    record = {
        "what": "end-to-end real-JPEG training through the port's CLI: "
                "JPEGs -> make_list -> prototxt -> train -> snapshot -> "
                "resume -> extract -> eval",
        "device": device,
        "dataset": {"identities": IDS, "train_classes": TRAIN_CLASSES,
                    "zero_shot_test_classes": IDS - TRAIN_CLASSES,
                    "images_per_id": PER_ID, "side": args.side,
                    "format": "jpeg q92",
                    "train_images": geometry["n_train"]},
        "pipeline": {"native": args.native, "crop": args.crop,
                     "mirror": args.mirror, "model": args.model,
                     "weights": args.weights,
                     "mining": "GLOBAL/HARD margin_diff=-0.05"},
        **res,
        "summary": {
            "first_avg_loss": train_curve[0]["loss"],
            "final_avg_loss": train_curve[-1]["loss"],
            "final_train_r1": final_train_r1,
            "first_unseen_test_r1": first_unseen,
            "final_unseen_test_r1": final_unseen,
            "resumed_final_unseen_test_r1": resumed_unseen,
            "unseen_gallery_r1": gallery_r1,
            "r1_bar": args.r1_bar, "unseen_bar": args.unseen_bar},
        "ok": ok,
    }
    path = os.path.join(ws, "e2e_real_jpeg.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"[e2e] {'OK' if ok else 'FAIL'}: loss "
          f"{train_curve[0]['loss']:.3f} -> {train_curve[-1]['loss']:.3f}, "
          f"zero-shot R@1 {first_unseen:.3f} -> {final_unseen:.3f} "
          f"(resumed {resumed_unseen}, gallery {gallery_r1}), record {path}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
