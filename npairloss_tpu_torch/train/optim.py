"""Caffe-semantics SGD and learning-rate policies (port of
``npairloss_tpu/train/optim.py``).

Caffe folds the learning rate in BEFORE momentum accumulation:
    v <- momentum * v + lr * lr_mult * (grad + weight_decay * decay_mult * w)
    w <- w - v
``torch.optim.SGD`` applies lr after the momentum buffer, which differs
whenever the schedule changes lr mid-run, so it does not stand in here.
Rates are computed in fp32, as the JAX schedule computes them.
"""

from __future__ import annotations

from typing import (Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from npairloss_tpu_torch.obs.perf import count

Mults = Tuple[Tuple[float, float], Tuple[float, float]]

_F = np.float32


def lr_schedule(policy: str, base_lr: float, gamma: float = 0.1,
                stepsize: int = 100000, power: float = 1.0,
                max_iter: int = 0, stepvalues: Sequence[int] = ()
                ) -> Callable[[int], float]:
    """Caffe lr_policy -> rate(step), an fp32 value as a Python float.
    Policies: fixed, step, exp, inv, multistep, poly, sigmoid."""
    base, g = _F(base_lr), _F(gamma)

    if policy == "fixed":
        rate = lambda step: base  # noqa: E731
    elif policy == "step":
        rate = lambda step: base * g ** np.floor(  # noqa: E731
            _F(step) / _F(stepsize))
    elif policy == "exp":
        rate = lambda step: base * g ** _F(step)  # noqa: E731
    elif policy == "inv":
        rate = lambda step: base * (  # noqa: E731
            _F(1.0) + g * _F(step)) ** _F(-power)
    elif policy == "multistep":
        sv = list(stepvalues) or [np.iinfo(np.int32).max]
        rate = lambda step: base * g ** _F(  # noqa: E731
            sum(int(step) >= v for v in sv))
    elif policy == "poly":
        if max_iter <= 0:
            raise ValueError("lr_policy 'poly' requires max_iter > 0")
        mi = _F(max_iter)
        # Clamped like Caffe so steps past max_iter stay at 0, not NaN.
        rate = lambda step: base * (  # noqa: E731
            _F(1.0) - np.minimum(_F(step), mi) / mi) ** _F(power)
    elif policy == "sigmoid":
        rate = lambda step: base / (  # noqa: E731
            _F(1.0) + np.exp(-g * (_F(step) - _F(stepsize))))
    else:
        raise ValueError(f"unknown lr_policy {policy!r}")
    return lambda step: float(_F(rate(step)))


def conv_bias_names(names: Sequence[str]) -> set:
    """Caffe 'second blob' biases: a parameter named ``bias`` whose parent
    module also holds a ``weight`` (conv and dense layers under any
    module name; never a normalization layer's shift)."""
    have = set(names)
    out = set()
    for n in names:
        parent, _, leaf = n.rpartition(".")
        if leaf == "bias" and (f"{parent}.weight" if parent else "weight") in have:
            out.add(n)
    return out


def param_mults(names: Sequence[str], mults: Optional[Mults] = None
                ) -> Dict[str, Tuple[float, float]]:
    """name -> (lr_mult, decay_mult): Caffe's ``param { lr_mult
    decay_mult }`` recipe ``((w_lr, w_decay), (b_lr, b_decay))`` split by
    ``conv_bias_names``; None = 1/1 for every parameter."""
    if mults is None:
        return {n: (1.0, 1.0) for n in names}
    w = (float(mults[0][0]), float(mults[0][1]))
    b = (float(mults[1][0]), float(mults[1][1]))
    biases = conv_bias_names(names)
    return {n: (b if n in biases else w) for n in names}


def scaled_lr(lr: Union[float, torch.Tensor],
              lmul: float) -> Union[float, torch.Tensor]:
    """``lr * lr_mult`` rounded to fp32: a float for a host lr, a 0-d
    fp32 device tensor for a device lr.  Both are one fp32 product of
    the same two fp32 operands, so they are equal bit for bit; the
    device form lets a captured CUDA graph read an lr written before
    each replay instead of baking the capture step's."""
    if isinstance(lr, torch.Tensor):
        return lr.to(torch.float32) * float(_F(lmul))
    return float(_F(lr) * _F(lmul))


@torch.no_grad()
def caffe_sgd(params: Mapping[str, torch.Tensor],
              grads: Mapping[str, Optional[torch.Tensor]],
              momentum_buf: Mapping[str, torch.Tensor],
              lr: Union[float, torch.Tensor],
              momentum: float = 0.9, weight_decay: float = 0.0,
              mults: Optional[Mapping[str, Tuple[float, float]]] = None
              ) -> None:
    """One Caffe SGD update, in place on ``params`` and ``momentum_buf``
    (fp32 buffers), every product and sum rounded on its own as the JAX
    update computes it.  A missing grad counts as zero.  ``lr`` is a
    host float or a 0-d fp32 tensor on the parameters' device
    (:func:`scaled_lr`)."""
    mu = float(_F(momentum))
    # The step counter's regions (obs.perf.count; no-ops otherwise).
    update, apply = count.scope("optim/update"), count.scope("optim/apply")
    for name, w in params.items():
        lmul, dmul = (mults or {}).get(name, (1.0, 1.0))
        with update:
            g = grads.get(name)
            g = torch.zeros_like(w, dtype=torch.float32) if g is None \
                else g.float()
            if weight_decay and dmul:
                g = g + w.float() * float(_F(weight_decay) * _F(dmul))
            v = momentum_buf[name]
            v.mul_(mu).add_(g * scaled_lr(lr, lmul))
        with apply:
            w.sub_(v.to(w.dtype))
