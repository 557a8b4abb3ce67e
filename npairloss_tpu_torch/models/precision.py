"""Declarative mixed-precision policy for the port's trunks — port of
``npairloss_tpu/models/precision.py``.

One :class:`PrecisionPolicy` answers, for every module of a trunk, what
dtype its parameters are stored in, what dtype it computes in, and which
gemm precision its products run at.  A module resolves its answer by
regex-matching its *flax* module path (``"inception_3a/b1x1"``, the
``"/"``-joined path the JAX package's rules are written against, not
torch's dotted name) against the policy's ``rules``, first match wins,
falling back to the policy-wide defaults.

Shipped policies (``get_policy`` / ``available_policies``), with the JAX
package's fields:

* ``"mxu"`` — the flagship default: bf16 compute over fp32 parameters,
  the loss engines' gemms in the single-pass bf16 mode
  (``loss_matmul_precision="default"``: operands rounded to bf16,
  products accumulated in fp32).  BatchNorm statistics and L2 normalize
  stay fp32 whatever the compute dtype.
* ``"bf16"`` — bf16 compute, fp32 parameters, full-fp32 loss gemms.
* ``"fp32_parity"`` — fp32 everything: the parity fallback every
  reference comparison is made against.

``matmul_precision`` keeps the JAX vocabulary: ``None`` (leave unset),
``"default"`` (single-pass bf16) and ``"highest"`` (full fp32).  On the
card a convolution's precision is set by its compute dtype (TF32 stays
off, ``device.set_parity_precision``), so a module's
``matmul_precision`` is recorded, not applied; the loss engines apply
``loss_matmul_precision``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

# The overridable per-module fields a rule may set.
_RULE_FIELDS = ("param_dtype", "compute_dtype", "matmul_precision")

_PRECISIONS = (None, "default", "highest")

# JAX's dtype names (``jnp.dtype(x).name``) for what ``describe`` prints.
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}


def dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's name of a torch dtype (``"float32"``, ...)."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None


@dataclasses.dataclass(frozen=True)
class ModulePrecision:
    """The resolved answer for one module."""

    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    matmul_precision: Optional[str]


def _check_precision(what: str, prec) -> None:
    if prec not in _PRECISIONS:
        raise ValueError(
            f"{what} must be one of "
            f"{sorted(k for k in _PRECISIONS if k)} or None, got {prec!r}")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Mixed-precision recipe for a whole trunk.

    ``rules`` is an ordered tuple of ``(regex, overrides)`` pairs matched
    (``re.search``) against the ``"/"``-joined flax module path; the
    first match wins and its overrides replace the policy-wide defaults
    for that module.  ``loss_matmul_precision`` is what the Solver hands
    the loss engines when the caller does not set ``matmul_precision``
    (None = full fp32 there)."""

    name: str
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32
    matmul_precision: Optional[str] = None
    loss_matmul_precision: Optional[str] = None
    rules: Tuple[Tuple[str, Mapping[str, Any]], ...] = ()

    def __post_init__(self):
        _check_precision("matmul_precision", self.matmul_precision)
        _check_precision("loss_matmul_precision", self.loss_matmul_precision)
        for pat, over in self.rules:
            re.compile(pat)  # a bad regex raises here
            unknown = set(over) - set(_RULE_FIELDS)
            if unknown:
                raise ValueError(
                    f"rule {pat!r} sets unknown field(s) "
                    f"{sorted(unknown)}; allowed: {_RULE_FIELDS}")
            if "matmul_precision" in over and \
                    over["matmul_precision"] not in _PRECISIONS:
                raise ValueError(
                    f"rule {pat!r}: matmul_precision "
                    f"{over['matmul_precision']!r} not in "
                    f"{sorted(k for k in _PRECISIONS if k)}")

    def resolve(self, path: Union[str, Sequence[str], None]
                ) -> ModulePrecision:
        """Precision of the module at ``path`` (a sequence of flax module
        names or an already ``"/"``-joined string)."""
        name = path if isinstance(path, str) else "/".join(path or ())
        base = {"param_dtype": self.param_dtype,
                "compute_dtype": self.compute_dtype,
                "matmul_precision": self.matmul_precision}
        for pat, over in self.rules:
            if re.search(pat, name) is not None:
                base.update(over)
                break
        return ModulePrecision(**base)

    def describe(self) -> Dict[str, Any]:
        """JSON-able summary, with the JAX package's dtype names."""
        return {
            "name": self.name,
            "param_dtype": dtype_name(self.param_dtype),
            "compute_dtype": dtype_name(self.compute_dtype),
            "output_dtype": dtype_name(self.output_dtype),
            "matmul_precision": self.matmul_precision,
            "loss_matmul_precision": self.loss_matmul_precision,
            "rules": [[pat, dict(over)] for pat, over in self.rules],
        }


_POLICIES: Dict[str, PrecisionPolicy] = {
    "mxu": PrecisionPolicy(
        name="mxu", param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        output_dtype=torch.float32, matmul_precision="default",
        loss_matmul_precision="default"),
    "bf16": PrecisionPolicy(
        name="bf16", param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        output_dtype=torch.float32, matmul_precision=None,
        loss_matmul_precision=None),
    "fp32_parity": PrecisionPolicy(
        name="fp32_parity", param_dtype=torch.float32,
        compute_dtype=torch.float32, output_dtype=torch.float32,
        matmul_precision=None, loss_matmul_precision=None),
}

DEFAULT_POLICY = "mxu"


def get_policy(name: Union[str, PrecisionPolicy]) -> PrecisionPolicy:
    """A policy by name (a policy passes through); an unknown name raises
    ``KeyError`` naming the known ones."""
    if isinstance(name, PrecisionPolicy):
        return name
    key = str(name).lower()
    if key not in _POLICIES:
        raise KeyError(f"unknown precision policy {name!r}; have "
                       f"{sorted(_POLICIES)}")
    return _POLICIES[key]


def available_policies() -> Sequence[str]:
    return sorted(_POLICIES)


def module_precision(policy: Optional[PrecisionPolicy],
                     path: Union[str, Sequence[str], None],
                     fallback_dtype: torch.dtype) -> ModulePrecision:
    """What a module calls: without a policy, ``fallback_dtype`` compute
    over fp32 parameters and no explicit precision (the policy-less
    trunk); with one, ``policy.resolve(path)``."""
    if policy is None:
        return ModulePrecision(param_dtype=torch.float32,
                               compute_dtype=fallback_dtype,
                               matmul_precision=None)
    return policy.resolve(path)
