"""The port's data pipeline (npairloss_tpu_torch/data/) against the JAX
package's (npairloss_tpu/data/) on the CPU.

Tolerances:
  * the sampler's index streams: equal;
  * the DataTransformer warp, given JAX's own draws (re-derived here from
    the same ``jax.random`` keys): within 1e-3 absolute on 0-255 pixels —
    the same fp32 formula, with cos/sin and the sampling weights rounded
    by another library;
  * transform_param, given the same crop offsets and mirror flags, and
    the TEST centre crop: equal (one fp32 subtract and multiply, then
    gathers);
  * the Python loader under an identity transform: equal batches
    (uint8 -> fp32 is exact on both sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from npairloss_tpu.config import schema as jschema
from npairloss_tpu.data import loader as jloader
from npairloss_tpu.data import sampler as jsampler
from npairloss_tpu.data import transforms as jt
from npairloss_tpu_torch.config import schema as tschema
from npairloss_tpu_torch.data import dataset as tdataset
from npairloss_tpu_torch.data import loader as tloader
from npairloss_tpu_torch.data import sampler as tsampler
from npairloss_tpu_torch.data import transforms as tt

WARP_ATOL = 1e-3


# -- sampler ----------------------------------------------------------------


# 9 identities of 1-5 images: those with fewer than 3 take the
# with-replacement branch.
LABELS = np.repeat(np.arange(9), [1, 2, 3, 4, 5, 3, 4, 2, 5])


@pytest.mark.parametrize("rand_identity", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("ids,imgs", [(4, 3), (9, 2)])
def test_sampler_index_stream_equals_jax(rand_identity, shuffle, ids, imgs):
    """50 batches of indices, equal for the same seed: random and
    sequential identities (9 of 9 wraps every batch), shuffled or not."""
    kw = dict(rand_identity=rand_identity, shuffle=shuffle, seed=7)
    a = jsampler.IdentityBalancedSampler(LABELS, ids, imgs, **kw)
    b = tsampler.IdentityBalancedSampler(LABELS, ids, imgs, **kw)
    for _ in range(50):
        np.testing.assert_array_equal(next(b), next(a))


def test_sampler_refuses_too_few_identities():
    for mod in (jsampler, tsampler):
        with pytest.raises(ValueError, match="identities"):
            mod.IdentityBalancedSampler(LABELS, 10, 2)


# -- warp primitives ----------------------------------------------------------


def _images(n=3, h=12, w=10, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, h, w, 3)).astype(np.float32)


def test_bilinear_sample_matches_jax_with_border_clamp():
    """Coordinates inside, on and far outside the border."""
    img = _images(1)[0]
    rng = np.random.default_rng(1)
    ys = rng.uniform(-4, 16, (12, 10)).astype(np.float32)
    xs = rng.uniform(-4, 14, (12, 10)).astype(np.float32)
    ys[0, :3] = [-0.5, 11.0, 11.5]
    want = np.asarray(jt._bilinear_sample(jnp.asarray(img), jnp.asarray(ys),
                                          jnp.asarray(xs)))
    got = tt.bilinear_sample(torch.from_numpy(img)[None],
                             torch.from_numpy(ys)[None],
                             torch.from_numpy(xs)[None])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_ATOL)


@pytest.mark.parametrize("radius", [0.5, 2.0])
def test_smooth_field_matches_jax(radius):
    width = max(int(3 * radius), 1)
    k = tt.gaussian_kernel1d(radius, width)
    np.testing.assert_array_equal(k, jt._gaussian_kernel1d(radius, width))
    field = np.random.default_rng(2).standard_normal((2, 9, 13)).astype(
        np.float32)
    want = np.stack([np.asarray(jt._smooth_field(jnp.asarray(f),
                                                 jnp.asarray(k)))
                     for f in field])
    got = tt.smooth_field(torch.from_numpy(field), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# -- DataTransformer, given JAX's draws -------------------------------------

TRANSFORMERS = {
    "rotate": dict(rotate_angle_scope=0.4),
    "scale": dict(scale_w_scope=0.8, scale_h_scope=1.3),
    "translate": dict(translation_w_scope=3.0, translation_h_scope=2.0),
    "flip": dict(h_flip=True),
    "elastic": dict(elastic_transform=True, amplitude=2.0, radius=1.5),
    "all": dict(rotate_angle_scope=0.3, scale_w_scope=1.2,
                scale_h_scope=0.9, translation_w_scope=2.0,
                translation_h_scope=1.0, h_flip=True,
                elastic_transform=True, amplitude=1.0, radius=1.0),
}


def _jax_warp_draws(key, n, h, w, cfg):
    """The draws of jt.data_transformer, re-derived from its key."""
    ks = jax.random.split(key, 7)
    scope = float(cfg.rotate_angle_scope)

    def u(k, lo, hi):
        return np.asarray(jax.random.uniform(k, (n,), minval=lo, maxval=hi))

    def rng(s):
        s = float(s) if s else 1.0
        return (1.0, 1.0) if s <= 0 else (min(s, 1 / s), max(s, 1 / s))

    tw, th = float(cfg.translation_w_scope), float(cfg.translation_h_scope)
    flips = (np.asarray(jax.random.bernoulli(ks[5], 0.5, (n,)))
             if cfg.h_flip else np.zeros(n, bool))
    noise = (np.asarray(jax.random.normal(ks[6], (n, 2, h, w),
                                          dtype=jnp.float32))
             if cfg.elastic_transform else None)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return tt.WarpDraws(
        t(u(ks[0], -scope, scope)), t(u(ks[1], -tw, tw)),
        t(u(ks[2], -th, th)), t(u(ks[3], *rng(cfg.scale_w_scope))),
        t(u(ks[4], *rng(cfg.scale_h_scope))), t(flips),
        None if noise is None else t(noise))


@pytest.mark.parametrize("name", sorted(TRANSFORMERS))
def test_data_transformer_matches_jax_given_its_draws(name):
    imgs = _images()
    n, h, w, _ = imgs.shape
    jcfg = jschema.TransformerConfig(**TRANSFORMERS[name])
    tcfg = tschema.TransformerConfig(**TRANSFORMERS[name])
    key = jax.random.PRNGKey(3)
    want = np.asarray(jt.data_transformer(jnp.asarray(imgs), key, jcfg))
    draws = _jax_warp_draws(key, n, h, w, jcfg)
    got = tt.data_transformer(torch.from_numpy(imgs), tcfg, draws)
    assert got.dtype == torch.float32 and got.shape == imgs.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_ATOL)
    if name != "flip":  # the warp moved pixels
        assert np.abs(want - imgs).max() > 1.0


def test_warp_one_image_matches_jax_warp_one():
    """``warp`` at explicit parameters against ``_warp_one``: rotation,
    translation, anisotropic scale, flip and a displacement field."""
    img = _images(1, 11, 14, seed=4)[0]
    disp = np.random.default_rng(5).standard_normal((2, 11, 14)).astype(
        np.float32)
    args = (0.25, 1.5, -2.0, 1.1, 0.9, True)
    want = np.asarray(jt._warp_one(
        jnp.asarray(img), *[jnp.float32(a) for a in args[:5]],
        jnp.asarray(args[5]), (jnp.asarray(disp[0]), jnp.asarray(disp[1]))))
    col = lambda v: torch.tensor([v])  # noqa: E731
    got = tt.warp(torch.from_numpy(img)[None], *[col(a) for a in args[:5]],
                  torch.tensor([True]),
                  (torch.from_numpy(disp[0])[None],
                   torch.from_numpy(disp[1])[None]))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_ATOL)


def test_transformer_draws_stay_in_their_ranges():
    cfg = tschema.TransformerConfig(**TRANSFORMERS["all"])
    g = torch.Generator().manual_seed(0)
    d = tt.transformer_draws(400, 6, 5, cfg, g)
    assert d.angle.abs().max() <= 0.3 and d.tx.abs().max() <= 2.0
    assert d.sx.min() >= 1 / 1.2 and d.sx.max() <= 1.2
    assert d.sy.min() >= 0.9 and d.sy.max() <= 1 / 0.9
    assert 0 < int(d.flip.sum()) < 400 and d.noise.shape == (400, 2, 6, 5)


# -- transform_param ---------------------------------------------------------

TRANSFORM_PARAMS = {
    "mean3_crop_mirror": dict(mean_value=(104.0, 117.0, 123.0), crop_size=7,
                              mirror=True),
    "mean1_scale": dict(mean_value=(120.0,), scale=0.5),
    "crop_only": dict(crop_size=9),
    "mirror_only": dict(mirror=True),
    "full_size_crop": dict(crop_size=10, mean_value=(1.0, 2.0, 3.0)),
}


def _jax_crop_draws(key, n, h, w, tp, train):
    """The crop offsets and mirror flags of jt.apply_transform_param."""
    crop = int(tp.crop_size)
    oy = ox = mirror = None
    if crop and (crop < h or crop < w):
        kh, kw, km = jax.random.split(key, 3)
        if train:
            oy = np.asarray(jax.random.randint(kh, (n,), 0, h - crop + 1))
            ox = np.asarray(jax.random.randint(kw, (n,), 0, w - crop + 1))
        else:
            oy = np.full(n, (h - crop) // 2)
            ox = np.full(n, (w - crop) // 2)
    else:
        km = key
    if tp.mirror and train:
        mirror = np.asarray(jax.random.bernoulli(km, 0.5, (n,)))
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.array(a))
    return tt.CropDraws(t(oy), t(ox), t(mirror))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", sorted(TRANSFORM_PARAMS))
def test_transform_param_equals_jax_given_its_draws(name, train):
    imgs = _images(6, 12, 10, seed=6)
    n, h, w, _ = imgs.shape
    jtp = jschema.TransformParam(**TRANSFORM_PARAMS[name])
    ttp = tschema.TransformParam(**TRANSFORM_PARAMS[name])
    key = jax.random.PRNGKey(9)
    want = np.asarray(jt.apply_transform_param(jnp.asarray(imgs), key, jtp,
                                               train))
    got = tt.apply_transform_param(
        torch.from_numpy(imgs.astype(np.uint8)), ttp, train,
        _jax_crop_draws(key, n, h, w, jtp, train))
    np.testing.assert_array_equal(got.numpy(), want)


def test_test_phase_draws_are_the_centre_crop_and_no_mirror():
    """The port's own TEST draws: the centre crop, no mirror — JAX's TEST
    output exactly."""
    imgs = _images(4, 12, 10, seed=8)
    tp = dict(crop_size=7, mirror=True, mean_value=(10.0, 20.0, 30.0))
    want = np.asarray(jt.apply_transform_param(
        jnp.asarray(imgs), jax.random.PRNGKey(0),
        jschema.TransformParam(**tp), False))
    got = tt.augment(torch.from_numpy(imgs), torch.Generator().manual_seed(0),
                     tp=tschema.TransformParam(**tp), train=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_transform_param_refusals_match_jax():
    imgs = _images(2, 6, 6)
    for tp, msg in ((dict(crop_size=8), "exceeds image size"),
                    (dict(mean_value=(1.0, 2.0)), "mean_value has 2")):
        with pytest.raises(ValueError, match=msg):
            jt.apply_transform_param(jnp.asarray(imgs),
                                     jax.random.PRNGKey(0),
                                     jschema.TransformParam(**tp), True)
        with pytest.raises(ValueError, match=msg):
            tt.augment(torch.from_numpy(imgs),
                       torch.Generator().manual_seed(0),
                       tp=tschema.TransformParam(**tp))


def test_augment_warps_in_train_only():
    imgs = torch.from_numpy(_images(2))
    cfg = tschema.TransformerConfig(rotate_angle_scope=0.5)
    g = torch.Generator().manual_seed(1)
    assert torch.equal(tt.augment(imgs, g, transformer=cfg, train=False),
                       imgs)
    assert not torch.equal(tt.augment(imgs, g, transformer=cfg), imgs)


# -- datasets and the Python loader ----------------------------------------


def write_ppm_list(root, n_ids=6, per_id=3, h=8, w=8, seed=0,
                   sizes=None):
    """PPM images of ``n_ids`` identities and their list file; returns
    the list's path."""
    rng = np.random.default_rng(seed)
    lines = []
    for ident in range(n_ids):
        for k in range(per_id):
            hh, ww = sizes(rng) if sizes else (h, w)
            arr = rng.integers(0, 256, (hh, ww, 3), dtype=np.uint8)
            name = f"id{ident}_{k}.ppm"
            with open(root / name, "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (ww, hh) + arr.tobytes())
            lines.append(f"{name}\t{ident}" if k == 1 else f"{name} {ident}")
    src = root / "list.txt"
    src.write_text("# identities\n" + "\n".join(lines) + "\n\n")
    return str(src)


def _layer(schema, root, src, **kw):
    base = dict(root_folder=str(root) + "/", source=src, batch_size=8,
                shuffle=True, new_height=8, new_width=8,
                identity_num_per_batch=4, img_num_per_identity=2,
                rand_identity=True,
                transform=schema.TransformParam(crop_size=8))
    base.update(kw)
    return schema.DataLayerConfig(**base)


def test_list_file_dataset_matches_jax(tmp_path):
    """Rows with spaces, tabs, comments and blank lines; PIL decode."""
    src = write_ppm_list(tmp_path)
    from npairloss_tpu.data.dataset import ListFileDataset as JDS

    a = JDS(str(tmp_path), src, 8, 8)
    b = tdataset.ListFileDataset(str(tmp_path), src, 8, 8)
    assert a.paths == b.paths and len(b) == 18
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.load_batch([0, 5, 17]),
                                  b.load_batch([0, 5, 17]))


def test_malformed_list_line_is_refused(tmp_path):
    (tmp_path / "bad.txt").write_text("a.ppm 0\nno_label_here\n")
    with pytest.raises(ValueError, match="malformed list line"):
        tdataset.ListFileDataset(str(tmp_path), str(tmp_path / "bad.txt"))


@pytest.mark.parametrize("train", [True, False])
def test_python_loader_batches_equal_jax(tmp_path, train):
    """``native="never"`` on both sides, identity transform (8 x 8
    images, crop 8, no mirror): the same six batches."""
    src = write_ppm_list(tmp_path)
    jcfg = _layer(jschema, tmp_path, src)
    tcfg = _layer(tschema, tmp_path, src)
    with jloader.multibatch_loader(jcfg, train=train, seed=3,
                                   native="never") as a, \
            tloader.multibatch_loader(tcfg, train=train, seed=3,
                                      native="never", device="cpu") as b:
        assert isinstance(b, tloader.MultibatchLoader)
        for _ in range(6):
            (xa, la), (xb, lb) = next(a), next(b)
            assert xb.dtype == torch.float32 and lb.dtype == torch.int32
            np.testing.assert_array_equal(xb.numpy(), np.asarray(xa))
            np.testing.assert_array_equal(lb.numpy(), la)


def test_loader_augments_on_the_device_side(tmp_path):
    """A crop below the image size and mirror: fp32 batches of the crop's
    shape, from the loader's own generator (seeded: two loaders agree)."""
    src = write_ppm_list(tmp_path)
    tp = tschema.TransformParam(crop_size=6, mirror=True,
                                mean_value=(104.0, 117.0, 123.0))
    cfg = _layer(tschema, tmp_path, src, transform=tp)
    with tloader.multibatch_loader(cfg, seed=5, native="never",
                                   device="cpu") as a, \
            tloader.multibatch_loader(cfg, seed=5, native="never",
                                      device="cpu") as b:
        xa, la = next(a)
        xb, lb = next(b)
    assert xa.shape == (8, 6, 6, 3) and xa.dtype == torch.float32
    assert torch.equal(xa, xb) and torch.equal(la, lb)
    assert float(xa.min()) < 0  # the mean came off


def test_default_transform_is_not_applied(tmp_path):
    """No transform_param and no DataTransformer: the batch as decoded."""
    src = write_ppm_list(tmp_path)
    cfg = _layer(tschema, tmp_path, src,
                 transform=tschema.TransformParam())
    ds = tdataset.ListFileDataset(str(tmp_path), src, 8, 8)
    with tloader.MultibatchLoader(ds, cfg, seed=1, device="cpu") as ldr:
        x, lab = next(ldr)
    idx = tsampler.IdentityBalancedSampler(ds.labels, 4, 2, seed=1)
    want = ds.load_batch(next(idx))
    np.testing.assert_array_equal(x.numpy(), want.astype(np.float32))


class _FailingDataset(tdataset.ArrayDataset):
    def __init__(self, fail_from: int):
        super().__init__(np.zeros((8, 4, 4, 3), np.uint8),
                         np.repeat(np.arange(4), 2))
        self.calls = 0
        self.fail_from = fail_from

    def load_batch(self, indices):
        self.calls += 1
        if self.calls > self.fail_from:
            raise OSError("disk gone")
        return super().load_batch(indices)


def test_worker_error_surfaces_with_its_batch_index():
    """A worker that keeps failing respawns ``max_worker_restarts`` times,
    then ``__next__`` raises PrefetchWorkerError naming the batch."""
    cfg = tschema.DataLayerConfig(identity_num_per_batch=2,
                                  img_num_per_identity=2)
    ldr = tloader.MultibatchLoader(_FailingDataset(fail_from=2), cfg,
                                   prefetch=1, max_worker_restarts=2,
                                   device="cpu")
    try:
        next(ldr), next(ldr)
        with pytest.raises(tloader.PrefetchWorkerError,
                           match="at batch 2 after 2 respawns") as exc:
            next(ldr)
        assert exc.value.batch_index == 2
        assert isinstance(exc.value.__cause__, OSError)
        with pytest.raises(StopIteration):
            next(ldr)
    finally:
        ldr.close()
    assert not ldr._thread.is_alive()


def test_native_routing_refusals():
    cfg = tschema.DataLayerConfig(source="x.txt")
    with pytest.raises(RuntimeError, match="new_height"):
        tloader.multibatch_loader(cfg, native="require", device="cpu")
    with pytest.raises(ValueError, match="auto/never/require"):
        tloader.multibatch_loader(cfg, native="sometimes", device="cpu")
