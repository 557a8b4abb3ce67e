"""The port's Inception-BN trunks (``googlenet_bn``, and
``googlenet_bn_s2d`` with ``fuse_1x1``) against the flax trunks on the
same weights and ``batch_stats``, carried over from the flax init by
``models/convert.py``.  64x64, batch 8.

Both sides are first held to each other computing in fp64 (flax under
``jax.enable_x64``, the port at ``dtype=torch.float64``; parameters,
input and embedding stay fp32, as the trunks' entry and exit casts
give): the same arithmetic then differs only by fp64 rounding, so the
comparison sees the semantics — biased fast variance, the 0.9/0.1
update, eps, which statistics each mode uses.  Tolerances there:
  * train-mode (batch statistics) and eval-mode (running statistics)
    embeddings within 1e-6 (the fp32 exit rounds once);
  * the updated running ``mean``/``var`` within 1e-6 — a variance
    without flax's biased estimator would be off by var/(N-1) ~ 1e-3;
  * the input gradient within 1e-5 of its largest entry, every
    parameter gradient within 1e-5 of its own largest entry.

In fp32 the flax trunk is itself 1e-4 from its fp64 result: XLA's CPU
reductions sum each channel's batch statistics sequentially, and the
fast variance E[x^2] - E[x]^2 cancels (ReLU outputs into a 1x1 conv have
a large mean against their spread).  PyTorch's pairwise sums keep the
port's fp32 trunk within 1e-5 of it.  So the fp32 port is held to the
fp64 flax trunk: embeddings within 3e-5, statistics within 1e-5 of
their scale (a running mean's scale: its largest entry or the sqrt of
the largest running variance beside it, whichever is larger).  The fp32 gradients through 57 BatchNorms over
as few as 32 values a channel are ill-conditioned (against the fp64
results: flax's fp32 input gradient of ``googlenet_bn`` is 4.1e-2 of its
largest entry off, the port's 1.1e-2, 4.7e-2 for the s2d trunk), so
gradients are compared in fp64 only (measured 9e-8 input, 1.6e-7
parameters there).  Remat against no remat, and every converter round
trip: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.models.layers import BatchNorm

TRUNKS = {"googlenet_bn": {}, "googlenet_bn_s2d": {"fuse_1x1": True}}
F64 = {"emb": 1e-6, "stats": 1e-6, "grad": 1e-5}
F32 = {"emb": 3e-5, "stats": 1e-5}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(TRUNKS))
def flax_run(request):
    """One jitted fp64 flax program per trunk (after the fp32 init): the
    train-mode forward with its updated batch_stats, the eval-mode
    forward on those statistics, and the gradients of a probe
    objective."""
    name = request.param
    kw = TRUNKS[name]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    probe = rng.standard_normal((8, 1024)).astype(np.float32)
    init = jax_get_model(name, dtype=jnp.float32, **kw).init
    variables = _np(jax.jit(lambda k, x: init(k, x, train=False))(
        jax.random.PRNGKey(3), jnp.asarray(x)))
    with jax.enable_x64(True):
        jm = jax_get_model(name, dtype=jnp.float64, **kw)

        def run(params, stats, x):
            def obj(p, x):
                emb, upd = jm.apply({"params": p, "batch_stats": stats}, x,
                                    train=True, mutable=["batch_stats"])
                return jnp.sum(emb * probe), (emb, upd["batch_stats"])

            (_, (emb, new)), (gp, gx) = jax.value_and_grad(
                obj, argnums=(0, 1), has_aux=True)(params, x)
            emb_eval = jm.apply({"params": params, "batch_stats": new}, x,
                                train=False)
            return emb, new, emb_eval, gp, gx

        out = _np(jax.jit(run)(variables["params"],
                               variables["batch_stats"], jnp.asarray(x)))
    return {"name": name, "kw": kw, "x": x, "probe": probe,
            "params": variables["params"],
            "stats": variables["batch_stats"],
            "emb": out[0], "new_stats": out[1], "emb_eval": out[2],
            "grad_params": out[3], "grad_x": out[4]}


def _port(run, remat=False, dtype=torch.float32):
    tm = get_model(run["name"], device="cpu", dtype=dtype, remat=remat,
                   **run["kw"])
    convert.load_jax_params(tm, run["params"], run["stats"])
    return tm


def _stats_of(tm):
    return convert.flatten_params(
        convert.to_jax_params(tm, with_batch_stats=True)[1])


def _stat_scale(stats, key):
    """A running mean's scale is its channels' spread too: sqrt of the
    largest running variance beside it."""
    if not key.endswith("/mean"):
        return None
    return float(np.sqrt(stats[key[:-len("mean")] + "var"].max()))


def _close(got, want, tol, what, scale=None):
    scale = max(float(np.abs(want).max()), scale or 0.0, 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max error {err:.3g} of max {scale:.3g}"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_bn_trunk_train_step_matches_flax(flax_run, dtype, monkeypatch):  # slow-ok: the BN trunk's step against flax in fp64
    run = flax_run
    tol = F64 if dtype == "float64" else F32
    # PyTorch's own convolutions (oneDNN's first call may pick another
    # algorithm).
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    tm = _port(run, dtype=getattr(torch, dtype)).train()
    x = torch.from_numpy(run["x"]).requires_grad_()
    emb = tm(x)
    assert emb.dtype == torch.float32
    np.testing.assert_allclose(emb.detach().numpy(), run["emb"],
                               rtol=tol["emb"], atol=tol["emb"])
    got = _stats_of(tm)
    want = convert.flatten_params(run["new_stats"])
    assert set(got) == set(want)
    assert len(got) == 2 * sum(isinstance(m, BatchNorm)
                               for m in tm.modules())
    for k in want:
        _close(got[k], want[k], tol["stats"], k, _stat_scale(want, k))
    if dtype == "float64":
        (emb * torch.from_numpy(run["probe"])).sum().backward()
        _close(x.grad.numpy(), run["grad_x"], tol["grad"], "input")
        want_g = convert.from_jax_params(run["grad_params"])
        params = dict(tm.named_parameters())
        assert set(params) == set(want_g)
        for name, w in want_g.items():
            _close(params[name].grad.numpy(), w.numpy(), tol["grad"], name)
    # Eval mode normalizes by the running statistics just updated, and
    # leaves them as they are.
    tm.eval()
    with torch.no_grad():
        emb_eval = tm(torch.from_numpy(run["x"]))
    np.testing.assert_allclose(emb_eval.numpy(), run["emb_eval"],
                               rtol=tol["emb"], atol=tol["emb"])
    after = _stats_of(tm)
    assert after.keys() == got.keys()
    for k, v in after.items():
        assert np.array_equal(v, got[k]), k


def test_remat_equals_no_remat_bit_for_bit(flax_run):  # slow-ok: the only remat bit-identity check
    """Checkpointed blocks re-run their forward in the backward: the
    embeddings, every gradient and the running statistics are the same
    bits as without remat, and the statistics moved once (equal to one
    forward's update, which flax's agree with)."""
    run = flax_run
    out = {}
    for remat in (False, True):
        tm = _port(run, remat=remat).train()
        x = torch.from_numpy(run["x"]).requires_grad_()
        emb = tm(x)
        (emb * torch.from_numpy(run["probe"])).sum().backward()
        out[remat] = (emb.detach(), x.grad,
                      {n: p.grad for n, p in tm.named_parameters()},
                      {n: b.clone() for n, b in tm.named_buffers()})
    (e0, gx0, gp0, b0), (e1, gx1, gp1, b1) = out[False], out[True]
    assert torch.equal(e0, e1) and torch.equal(gx0, gx1)
    assert gp0.keys() == gp1.keys() and b0.keys() == b1.keys()
    for n in gp0:
        assert torch.equal(gp0[n], gp1[n]), n
    for n in b0:
        assert torch.equal(b0[n], b1[n]), n
    want = convert.flatten_params(run["new_stats"])
    for n, b in b1.items():
        k = n.replace(".", "/")
        _close(b.numpy(), want[k], F32["stats"], n, _stat_scale(want, k))


def test_batch_norm_semantics_are_flax_not_batchnorm2d():
    """The biased fast variance, clipped at 0; the 0.9/0.1 update; fp32
    statistics of a bf16 input; no ``num_batches_tracked``; eval mode
    leaves the buffers alone."""
    torch.manual_seed(0)
    bn = BatchNorm(3, dtype=torch.bfloat16).train()
    x = (torch.randn(4, 5, 5, 3) * 2 + 1).to(torch.bfloat16)
    y = bn(x)
    xf = x.float().reshape(-1, 3)
    mean = xf.mean(0)
    var = torch.clamp_min((xf * xf).mean(0) - mean * mean, 0.0)
    assert y.dtype == torch.bfloat16
    assert torch.equal(bn.mean, 0.9 * torch.zeros(3) + 0.1 * mean)
    assert torch.equal(bn.var, 0.9 * torch.ones(3) + 0.1 * var)
    assert not torch.allclose(var, xf.var(0), rtol=1e-3)  # not unbiased
    want = ((xf - mean) * torch.rsqrt(var + 1e-5)).to(torch.bfloat16)
    assert torch.equal(y.reshape(-1, 3), want)
    assert sorted(dict(bn.named_buffers())) == ["mean", "var"]
    assert sorted(dict(bn.named_parameters())) == ["bias", "scale"]
    before = bn.mean.clone()
    bn.eval()(x)
    assert torch.equal(bn.mean, before)


def test_converter_round_trip_with_batch_stats(flax_run, tmp_path):
    """flax params + batch_stats -> the port -> back: the same trees bit
    for bit; through a wrapped .npz weights file too; and a plain-layout
    ``googlenet_bn`` tree (7x7 stem, three 1x1s) loads into
    ``googlenet_bn_s2d`` with ``fuse_1x1`` (the s2d stem keeps its
    BatchNorm_0, the statistics are concatenated like the kernels) and
    computes the same embeddings."""
    run = flax_run
    tm = _port(run)
    params, stats = convert.to_jax_params(tm, with_batch_stats=True)
    for got, want in ((params, run["params"]), (stats, run["stats"])):
        g, w = convert.flatten_params(got), convert.flatten_params(want)
        assert g.keys() == w.keys()
        for k in w:
            assert np.array_equal(g[k], w[k]), k
    path = str(tmp_path / "w.npz")
    convert.save_weights_npz(params, path, batch_stats=stats)
    tree = convert.read_weights_npz(path)
    assert set(tree) == {"params", "batch_stats"}
    tm2 = get_model(run["name"], device="cpu", dtype=torch.float32, seed=9,
                    **run["kw"])
    convert.load_weights_npz(tm2, path)
    for (k, a), (_, b) in zip(tm.state_dict().items(),
                              tm2.state_dict().items()):
        assert torch.equal(a, b), k
    # Params alone keep the model's own running statistics.
    tm3 = get_model(run["name"], device="cpu", dtype=torch.float32,
                    **run["kw"])
    with torch.no_grad():
        tm3.conv1.BatchNorm_0.var.fill_(2.0)
    convert.load_jax_params(tm3, run["params"])
    assert torch.all(tm3.conv1.BatchNorm_0.var == 2.0)
    if run["name"] != "googlenet_bn":
        return
    fused = get_model("googlenet_bn_s2d", device="cpu", dtype=torch.float32,
                      fuse_1x1=True)
    convert.load_jax_params(fused, {"params": run["params"],
                                    "batch_stats": run["new_stats"]})
    with torch.no_grad():
        a = fused.eval()(torch.from_numpy(run["x"]))
    np.testing.assert_allclose(a.numpy(), run["emb_eval"], rtol=F32["emb"],
                               atol=F32["emb"])
