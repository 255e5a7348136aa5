"""The port's host data path against the JAX package's, on the same inputs:
the sampler's indices (world, rank, epoch, repeated_aug), the sources
(synthetic, CIFAR pickles written here, an ImageFolder tree and the Flowers-102
and Caltech-256 layouts written with PIL and scipy), the Loader's batches,
padding and n_valid, all exactly; the Loader's thread after an early
abandon, its forwarding of an exception from get_batch; and the DataLoader
route of ``--data-loader tfdata``, batch for batch against the Loader.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from deltakd_tpu.data import pipeline as jpipeline
from deltakd_tpu.data import sampler as jsampler
from deltakd_tpu.data import sources as jsources
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.data import loader as ploader
from deltakd_tpu_torch.data import pipeline as ppipeline
from deltakd_tpu_torch.data import sampler as psampler
from deltakd_tpu_torch.data import sources as psources

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [100, 1000, 1537])
@pytest.mark.parametrize("world,rank", [(1, 0), (4, 0), (4, 3), (3, 1)])
@pytest.mark.parametrize("is_train,repeated_aug", [(True, True), (True, False),
                                                   (False, True)])
def test_epoch_indices_match_jax(n, world, rank, is_train, repeated_aug):
    for epoch in (0, 5):
        kw = dict(is_train=is_train, world=world, rank=rank,
                  repeated_aug=repeated_aug, seed=42)
        np.testing.assert_array_equal(psampler.epoch_indices(epoch, n, **kw),
                                      jsampler.epoch_indices(epoch, n, **kw))


def test_shard_and_repeated_aug_indices_match_jax():
    for fn in ("shard_indices", "repeated_aug_indices"):
        for world in (1, 2, 8):
            for rank in range(world):
                a = getattr(psampler, fn)(3, 2000, world=world, rank=rank, seed=7)
                b = getattr(jsampler, fn)(3, 2000, world=world, rank=rank, seed=7)
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(psampler.shard_indices(1, 50, shuffle=False),
                                  np.arange(50))


def _same_source(a, b, idx):
    assert len(a) == len(b) and a.num_classes == b.num_classes
    assert tuple(a.raw_hw) == tuple(b.raw_hw)
    xa, ya = a.get_batch(np.asarray(idx))
    xb, yb = b.get_batch(np.asarray(idx))
    assert xa.dtype == np.uint8 and ya.dtype == np.int32
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("dataset,input_size,is_train",
                         [("synthetic", 32, True), ("synthetic", 32, False),
                          ("flowers", 96, True)])
def test_synthetic_source_matches_jax(dataset, input_size, is_train):
    from deltakd_tpu.configs.config import TrainConfig as JTrainConfig

    kw = dict(dataset=dataset, input_size=input_size, synthetic_data=True)
    a = psources.build_source(TrainConfig(**kw), is_train)
    b = jsources.build_source(JTrainConfig(**kw), is_train)
    _same_source(a, b, [0, 5, len(a) - 1, 5])


def _write_cifar(root, dataset, n_train, n_test, seed=0):
    rng = np.random.RandomState(seed)
    if dataset == "cifar-100":
        base, label_key = os.path.join(root, "cifar-100-python"), "fine_labels"
        files = {"train": n_train, "test": n_test}
        classes = 100
    else:
        base, label_key = os.path.join(root, "cifar-10-batches-py"), "labels"
        files = {**{f"data_batch_{i}": n_train for i in range(1, 6)},
                 "test_batch": n_test}
        classes = 10
    os.makedirs(base)
    for name, n in files.items():
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072), dtype=np.uint8),
                         label_key: rng.randint(0, classes, n).tolist()}, f)


@pytest.mark.parametrize("dataset", ["cifar-100", "cifar-10"])
def test_cifar_source_matches_jax(tmp_path, dataset):
    _write_cifar(str(tmp_path), dataset, 20, 12)
    for is_train in (True, False):
        a = psources.cifar_source(str(tmp_path), dataset, is_train)
        b = jsources.cifar_source(str(tmp_path), dataset, is_train)
        _same_source(a, b, np.arange(len(a))[::-1])


def _write_tree(root, classes=3, per_class=4, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"class_{c}"))
        for i in range(per_class):
            h, w = rng.randint(20, 48, size=2)
            Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(root, f"class_{c}", f"img_{i}.png"))


def test_folder_source_matches_jax(tmp_path):
    _write_tree(str(tmp_path))
    a = psources.FolderSource(str(tmp_path), raw_size=32, num_workers=2)
    b = jsources.FolderSource(str(tmp_path), raw_size=32, num_workers=2)
    assert a.samples == b.samples and a.class_to_idx == b.class_to_idx
    _same_source(a, b, np.arange(len(a)))


def test_native_layouts_match_jax(tmp_path):
    """Flowers-102 (jpg/ + .mat files) and Caltech-256 through build_source."""
    from PIL import Image
    from scipy.io import savemat

    from deltakd_tpu.configs.config import TrainConfig as JTrainConfig

    rng = np.random.RandomState(1)
    base = tmp_path / "flowers" / "flowers-102"
    os.makedirs(base / "jpg")
    for i in range(1, 7):
        Image.fromarray(rng.randint(0, 256, (30, 40, 3), dtype=np.uint8)).save(
            base / "jpg" / f"image_{i:05d}.jpg")
    savemat(base / "imagelabels.mat", {"labels": np.array([3, 1, 102, 7, 7, 2])})
    savemat(base / "setid.mat", {"trnid": np.array([1, 3, 5]), "valid": np.array([2, 4, 6])})
    cal = tmp_path / "cal" / "caltech256" / "256_ObjectCategories"
    for c in ("001.ak47", "002.bat"):
        os.makedirs(cal / c)
        for i in range(2):
            Image.fromarray(rng.randint(0, 256, (25, 25, 3), dtype=np.uint8)).save(
                cal / c / f"{i}.jpg")
    for dataset, root in (("flowers", tmp_path / "flowers"), ("caltech256", tmp_path / "cal")):
        kw = dict(dataset=dataset, data_path=str(root), input_size=32, num_workers=2)
        for is_train in (True, False):
            a = psources.build_source(TrainConfig(**kw), is_train)
            b = jsources.build_source(JTrainConfig(**kw), is_train)
            assert a.samples == b.samples and a.raw_size == b.raw_size == 256
            _same_source(a, b, np.arange(len(a)))


@pytest.mark.parametrize("is_train,batch_size", [(True, 32), (False, 32), (False, 7)])
def test_loader_batches_match_jax(is_train, batch_size):
    src = psources.synthetic_source(n=100, hw=8, num_classes=10, seed=3)
    jsrc = jsources.ArraySource(src.images, src.labels, 10)
    a = ppipeline.Loader(src, batch_size=batch_size, is_train=is_train, seed=5)
    b = jpipeline.Loader(jsrc, batch_size=batch_size, is_train=is_train, seed=5)
    assert len(a) == len(b) == (100 // batch_size if is_train else -(-100 // batch_size))
    for epoch in (0, 1):
        got, want = list(a.epoch(epoch)), list(b.epoch(epoch))
        assert len(got) == len(want) == len(a)
        for (xa, ya, na), (xb, yb, nb) in zip(got, want):
            assert na == nb and xa.shape[0] == batch_size
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    if not is_train:   # the padded tail
        assert got[-1][2] == 100 - (len(a) - 1) * batch_size


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == ppipeline.THREAD_NAME]


def test_loader_abandoned_early_leaves_no_thread():
    src = psources.synthetic_source(n=256, hw=8, num_classes=10)
    loader = ppipeline.Loader(src, batch_size=8, is_train=True, prefetch=1)
    gen = loader.epoch(0)
    next(gen)
    assert _loader_threads()
    gen.close()
    deadline = time.time() + 10
    while _loader_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _loader_threads()


def test_loader_forwards_get_batch_errors():
    class Bad(psources.ArraySource):
        def get_batch(self, indices):
            raise OSError("corrupt image")

    src = psources.synthetic_source(n=64, hw=8, num_classes=10)
    loader = ppipeline.Loader(Bad(src.images, src.labels, 10), batch_size=8, is_train=True)
    with pytest.raises(OSError, match="corrupt image"):
        list(loader.epoch(0))


@pytest.mark.parametrize("is_train,num_workers", [(True, 0), (False, 0), (False, 2)])
def test_dataloader_route_matches_loader(tmp_path, is_train, num_workers):
    _write_tree(str(tmp_path), classes=3, per_class=5)
    cfg = TrainConfig(data_loader="tfdata", num_workers=num_workers, dataset="imagenet-1k",
                      data_path=str(tmp_path), input_size=32)
    src = psources.build_source(cfg, is_train)
    dl = ploader.make_loader(cfg, src, is_train=is_train, batch_size=4, seed=2)
    assert isinstance(dl, ploader.TorchDataLoader)
    ref = ppipeline.Loader(src, batch_size=4, is_train=is_train, seed=2)
    assert len(dl) == len(ref)
    got, want = list(dl.epoch(1)), list(ref.epoch(1))
    assert len(got) == len(want) == len(ref)
    for (xa, ya, na), (xb, yb, nb) in zip(got, want):
        assert isinstance(xa, torch.Tensor) and xa.dtype == torch.uint8
        assert na == nb
        np.testing.assert_array_equal(xa.numpy(), xb)
        np.testing.assert_array_equal(ya.numpy(), yb)


def test_dataloader_route_falls_back_on_arrays():
    cfg = TrainConfig(data_loader="tfdata")
    src = psources.synthetic_source(n=16, hw=8)
    with pytest.warns(UserWarning, match="falling back"):
        loader = ploader.make_loader(cfg, src, is_train=True, batch_size=4)
    assert isinstance(loader, ppipeline.Loader)
