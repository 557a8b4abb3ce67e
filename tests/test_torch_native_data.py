"""The port's binding of the native data runtime (npairloss_tpu_torch/
data/native.py) against the JAX package's (npairloss_tpu/data/native.py):
both build ``native/npair_data.cpp`` with g++, each into its own
directory.  For the same seed and thread count the two give the same
uint8 batches, equal (no arithmetic between them: the same C++ code
decodes, resizes and samples); so do the two native loaders under an
identity transform.
"""

import ctypes

import numpy as np
import pytest
import torch

from npairloss_tpu.config import schema as jschema
from npairloss_tpu.data import loader as jloader
from npairloss_tpu.data import native as jnative
from npairloss_tpu_torch.config import schema as tschema
from npairloss_tpu_torch.data import loader as tloader
from npairloss_tpu_torch.data import native as tnative

from test_torch_data import _layer, write_ppm_list


def _sizes(rng):
    return int(rng.integers(9, 17)), int(rng.integers(9, 17))


def test_build_lands_in_its_own_directory_with_every_signature_set():
    lib = tnative.library()
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.parent.name == \
        "native_torch"
    assert path.name.startswith("libnpair_data-")
    for name, (restype, argtypes) in tnative._SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.restype == restype and fn.argtypes == argtypes, name
    # Buffers travel as typed pointers, never as bare ints.
    assert tnative._SIGNATURES["nd_loader_next"][1] == [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_int)]
    assert set(tnative.native_suffixes()) >= {".ppm", ".pgm", ".bmp", ".npy"}


def test_dataset_matches_jax_binding(tmp_path):
    """Labels and resized images (OpenCV's half-pixel bilinear resize of
    9-16 px images to 12 x 10) equal through both bindings."""
    src = write_ppm_list(tmp_path, n_ids=4, per_id=3, sizes=_sizes)
    a = jnative.NativeListFileDataset(str(tmp_path), src, 12, 10)
    b = tnative.NativeListFileDataset(str(tmp_path), src, 12, 10)
    try:
        assert len(a) == len(b) == 12
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.dims(3) == b.dims(3) == (12, 10)
        np.testing.assert_array_equal(a.load_batch(range(12)),
                                      b.load_batch(range(12)))
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("rand_identity,shuffle", [(True, True),
                                                   (False, False)])
@pytest.mark.parametrize("threads", [1, 3])
def test_prefetcher_batches_equal_jax(tmp_path, rand_identity, shuffle,
                                      threads):
    src = write_ppm_list(tmp_path, sizes=_sizes)

    def run(mod, convert):
        ds = mod.NativeListFileDataset(str(tmp_path), src, 12, 10)
        out = []
        with mod.NativePrefetcher(ds, 3, 2, rand_identity=rand_identity,
                                  shuffle=shuffle, seed=11, threads=threads,
                                  prefetch=2) as pf:
            for _ in range(8):
                images, labels = next(pf)
                out.append((convert(images), convert(labels)))
        ds.close()
        return out

    want = run(jnative, np.array)
    got = run(tnative, lambda t: t.numpy().copy())
    for (xa, la), (xb, lb) in zip(want, got):
        assert xb.dtype == np.uint8 and lb.dtype == np.int32
        np.testing.assert_array_equal(xb, xa)
        np.testing.assert_array_equal(lb, la)


@pytest.mark.parametrize("train", [True, False])
def test_native_loader_batches_equal_jax(tmp_path, train):
    """``native="require"`` on both sides, identity transform (crop = the
    resize size, no mirror): the same batches, fp32 on the port's
    device."""
    src = write_ppm_list(tmp_path, sizes=_sizes)
    jcfg = _layer(jschema, tmp_path, src)
    tcfg = _layer(tschema, tmp_path, src)
    with jloader.multibatch_loader(jcfg, train=train, seed=2,
                                   native="require") as a, \
            tloader.multibatch_loader(tcfg, train=train, seed=2,
                                      native="require", device="cpu") as b:
        assert isinstance(b, tloader.NativeMultibatchLoader)
        for _ in range(5):
            (xa, la), (xb, lb) = next(a), next(b)
            assert xb.dtype == torch.float32 and xb.shape == (8, 8, 8, 3)
            np.testing.assert_array_equal(xb.numpy(), np.asarray(xa))
            np.testing.assert_array_equal(lb.numpy(), la)


def test_auto_routes_a_ppm_list_to_the_native_runtime(tmp_path):
    src = write_ppm_list(tmp_path)
    cfg = _layer(tschema, tmp_path, src)
    with tloader.multibatch_loader(cfg, native="auto", device="cpu") as ldr:
        assert isinstance(ldr, tloader.NativeMultibatchLoader)
    (tmp_path / "gif.txt").write_text("a.gif 0\nb.gif 1\n")
    gif = _layer(tschema, tmp_path, str(tmp_path / "gif.txt"),
                 identity_num_per_batch=2, img_num_per_identity=1)
    with tloader.multibatch_loader(gif, native="auto", device="cpu") as ldr:
        assert isinstance(ldr, tloader.MultibatchLoader)


def test_native_error_paths(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open list file"):
        tnative.NativeListFileDataset(str(tmp_path), str(tmp_path / "no"))
    (tmp_path / "bad.txt").write_text("a.ppm 0\nno_label_here\n")
    with pytest.raises(RuntimeError, match="malformed list line"):
        tnative.NativeListFileDataset(str(tmp_path),
                                      str(tmp_path / "bad.txt"), 4, 4)
    (tmp_path / "one.txt").write_text("missing.ppm 0\n")
    ds = tnative.NativeListFileDataset(str(tmp_path),
                                       str(tmp_path / "one.txt"), 4, 4)
    with pytest.raises(RuntimeError, match="cannot open file"):
        ds.load(0)
    with pytest.raises(RuntimeError, match="identities"):
        tnative.NativePrefetcher(ds, 2, 2)
    ds.close()
    with pytest.raises(RuntimeError, match="closed"):
        ds.load(0)


def test_native_worker_error_surfaces(tmp_path):
    """A decode failure on a worker thread surfaces in ``__next__``."""
    write_ppm_list(tmp_path, n_ids=1, per_id=2, h=4, w=4)
    (tmp_path / "mix.txt").write_text(
        "id0_0.ppm 0\nid0_1.ppm 0\nmissing.ppm 1\nmissing.ppm 1\n")
    ds = tnative.NativeListFileDataset(str(tmp_path),
                                       str(tmp_path / "mix.txt"), 4, 4)
    pf = tnative.NativePrefetcher(ds, 2, 2, seed=0, threads=1, prefetch=1)
    try:
        with pytest.raises(RuntimeError, match="cannot open file"):
            for _ in range(50):
                next(pf)
    finally:
        pf.close()
        ds.close()
