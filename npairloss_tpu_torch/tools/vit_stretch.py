"""The stretch configuration's ViT path on one card — the port of
``examples/vit_32k_stretch.py``'s single-device mode: ViT-B/16 (hidden
768, depth 12, 12 heads, MLP 3072, patch 16; bf16 over fp32 parameters)
-> L2 -> the blockwise N-pair loss (``--mining flagship``:
``REFERENCE_CONFIG``, GLOBAL/RELATIVE_HARD AP by streamed radix
selection; ``absolute``: LOCAL/HARD with margin_diff -0.05) in its bf16
mode, the five blockwise kernels on the card.

    python -m npairloss_tpu_torch.tools.vit_stretch --batch 4096 --image 64

A step is the trunk's training-mode forward on one synthetic batch of
identity pairs, the loss and its backward through the trunk to every
parameter (the JAX example differentiates to the embeddings only; a
training step needs the trunk's gradient, and so its activations: at
32,768 rows of 64² they would not fit one card without remat, which the
JAX ViT does not have).  ``--steps`` timed steps follow one warm-up
step; the script prints one JSON line: ms per step (CUDA events), the
embeddings per second, the loss, the peak allocated bytes and the
blockwise kernels' launches.  ``--device cpu`` runs the plain sweeps on
the CPU (small sizes only).  The ring over several cards
(``--mode ring`` in JAX) is not part of this tool.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def loss_config(mining: str):
    from npairloss_tpu_torch.ops.npair_loss import (
        REFERENCE_CONFIG,
        MiningMethod,
        NPairLossConfig,
    )

    if mining == "flagship":
        return REFERENCE_CONFIG
    return NPairLossConfig(margin_diff=-0.05,
                           an_mining_method=MiningMethod.HARD)


def run(batch: int, image: int, steps: int, mining: str, device=None,
        seed: int = 0, **model_kw) -> dict:
    """``steps`` timed training steps after one warm-up; the record
    :func:`main` prints (``model_kw`` shrinks the trunk for tests)."""
    import torch

    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.device import resolve_device, upload
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.ops.blockwise_npair import (
        blockwise_npair_loss_with_aux,
    )

    dev = resolve_device(device)
    cfg = loss_config(mining)
    model = get_model("vit_b16", device=dev, seed=seed, policy="mxu",
                      input_shape=(image, image, 3), **model_kw).train()
    x_np, lab_np = next(synthetic_identity_batches(
        batch // 2, batch // 2, 2, (image, image, 3), noise=0.5, seed=seed))
    x, lab = upload(x_np, dev), upload(lab_np, dev)
    params = [p for p in model.parameters()]

    def step():
        for p in params:
            p.grad = None
        emb = model(x)
        loss, _ = blockwise_npair_loss_with_aux(emb, lab, cfg,
                                                matmul_precision="default")
        loss.backward()
        return loss

    cuda = dev.type == "cuda"
    loss = step()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step()
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / steps
    else:
        ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {k: v for k, v in _build.launch_counts().items()
                if k.startswith(("npair_", "round_bf16"))}
    return {
        "model": "vit_b16", "batch": int(x.shape[0]), "image": image,
        "tokens": int(model.pos_embed.shape[1]), "mining": mining,
        "steps": steps, "ms_per_step": ms,
        "emb_per_sec": int(x.shape[0]) / ms * 1e3,
        "loss": float(loss.detach()),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                       else None),
        "launches": launches,
        "device": (torch.cuda.get_device_name(dev) if cuda else dev.type),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024,
                    help="rows of the pool (identity pairs)")
    ap.add_argument("--image", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mining", choices=["flagship", "absolute"],
                    default="flagship",
                    help="flagship = the shipped def.prototxt config "
                    "(GLOBAL/RELATIVE_HARD AP, streamed radix selection); "
                    "absolute = LOCAL/HARD only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "plain sweeps)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.batch < 2 or args.steps < 1:
        print("vit_stretch: --batch >= 2 and --steps >= 1", file=sys.stderr)
        return 2
    print(json.dumps(run(args.batch, args.image, args.steps, args.mining,
                         device=args.device, seed=args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
