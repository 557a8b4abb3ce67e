"""The random BN-free GoogLeNet trunk collapses at init in the reference,
and the port reproduces it: a recorded property of the reference, not a
port fault (ACCURACY.md, "collapses at init (all pairwise sims ≈
0.9999)"; npairloss_tpu/models/googlenet.py, the ``use_bn`` note).  The
cure is the reference's ``googlenet_bn`` variant.

The flax init of ``googlenet`` (fp32, ``PRNGKey(0)``) runs through the
JAX trunk and, carried across by ``convert.load_jax_params``, through the
port's.  Tolerances: embeddings within 1e-5 absolute (unit vectors after
~60 convolutions summed in another order; 1.9e-7 measured); the
off-diagonal cosine sims of both sets have mean > 0.999 and std < 1e-4
(6.4e-6 measured; random unit rows in 1024 dims give a std of ~0.03).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu_torch.models import convert, get_model


def _offdiag_cosines(emb: np.ndarray) -> np.ndarray:
    e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sims = e @ e.T
    return sims[~np.eye(len(e), dtype=bool)]


def test_random_trunk_collapses_in_the_reference_and_the_port_alike():
    x = np.random.default_rng(0).standard_normal(
        (8, 64, 64, 3)).astype(np.float32)
    jm = jax_get_model("googlenet", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                     train=False)["params"]
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v))(
        params, jnp.asarray(x)))
    tm = get_model("googlenet", device="cpu", dtype=torch.float32)
    convert.load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (8, 1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for name, emb in (("jax", want), ("port", got)):
        cos = _offdiag_cosines(emb)
        assert cos.mean() > 0.999, (name, cos.mean())
        assert cos.std() < 1e-4, (name, cos.std())
