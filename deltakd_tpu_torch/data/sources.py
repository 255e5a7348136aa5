"""Dataset sources (``deltakd_tpu/data/sources.py``): raw uint8 images and
labels, indexable for sharded sampling.

CIFAR reads the standard python-pickle archives from disk; imagenet, flowers,
caltech256 and stanford_cars read an ImageFolder-style tree or their
torchvision layout through PIL with a thread pool; ``synthetic`` generates
deterministic data. Sources return raw pixels: all augmentation runs on the
device (``data/augment.py``).

Folder images are standardised on the host to a fixed raw canvas
(shorter-side resize to ``raw_size`` + center crop) so that batches have
static shapes; the device's RandomResizedCrop then samples from that canvas.

PIL and scipy are imported only inside the folder readers, so the package
imports on a machine that has neither.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from deltakd_tpu_torch.data.registry import DATASET_STATS

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm")


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("reading image files needs PIL (the Pillow package); "
                          "CIFAR and --synthetic-data do not") from exc
    return Image


class ArraySource:
    """In-memory uint8 images [N, H, W, 3] + int labels [N]."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, num_classes: int):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"images must be uint8 [N, H, W, 3], got "
                             f"{images.dtype} {images.shape}")
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        self.num_classes = num_classes

    def __len__(self) -> int:
        return len(self.images)

    @property
    def raw_hw(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    def get_batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.images[indices], self.labels[indices]


def synthetic_source(n: int = 2048, hw: int = 32, num_classes: int = 100,
                     seed: int = 0) -> ArraySource:
    g = np.random.default_rng(seed)
    images = g.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    labels = g.integers(0, num_classes, (n,), dtype=np.int32)
    return ArraySource(images, labels, num_classes)


def _load_cifar_pickles(paths: Sequence[str], label_key: str
                        ) -> Tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    for p in paths:
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="latin1")
        xs.append(np.asarray(d["data"], np.uint8))
        ys.append(np.asarray(d[label_key], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.concatenate(ys)


def cifar_source(root: str, dataset: str, is_train: bool) -> ArraySource:
    """The standard CIFAR python archives (the files torchvision downloads:
    cifar-100-python/, cifar-10-batches-py/, or their .tar.gz)."""
    if dataset == "cifar-100":
        subdir, label_key = "cifar-100-python", "fine_labels"
        files = ["train"] if is_train else ["test"]
    else:
        subdir, label_key = "cifar-10-batches-py", "labels"
        files = ([f"data_batch_{i}" for i in range(1, 6)] if is_train
                 else ["test_batch"])
    base = os.path.join(root, subdir)
    if not os.path.isdir(base):
        tar = base + ".tar.gz" if os.path.exists(base + ".tar.gz") else os.path.join(
            root, {"cifar-100": "cifar-100-python.tar.gz",
                   "cifar-10": "cifar-10-python.tar.gz"}[dataset])
        if not os.path.exists(tar):
            raise FileNotFoundError(
                f"CIFAR archive not found under {root} (expected {subdir}/ or "
                f"its .tar.gz; place the standard archive there)")
        with tarfile.open(tar) as tf:
            tf.extractall(root)
    x, y = _load_cifar_pickles([os.path.join(base, f) for f in files], label_key)
    return ArraySource(x, y, DATASET_STATS[dataset]["num_classes"])


def decode_standardized(path: str, raw_size: int) -> np.ndarray:
    """One image file as uint8 [raw_size, raw_size, 3]: RGB, shorter side
    resized to ``raw_size`` (bilinear), center crop."""
    Image = _pil_image()
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        s = raw_size / min(w, h)
        im = im.resize((max(1, round(w * s)), max(1, round(h * s))), Image.BILINEAR)
        w, h = im.size
        left = (w - raw_size) // 2
        top = (h - raw_size) // 2
        im = im.crop((left, top, left + raw_size, top + raw_size))
        return np.asarray(im, np.uint8)


class FileListSource:
    """Lazily decoded image files from an explicit (path, label) list, decoded
    by a thread pool onto a ``raw_size`` square canvas
    (``decode_standardized``)."""

    def __init__(self, samples: List[Tuple[str, int]], num_classes: int,
                 raw_size: int = 256, num_workers: int = 8):
        _pil_image()   # fail early without PIL
        if not samples:
            raise FileNotFoundError("empty sample list")
        self.samples = samples
        self.num_classes = num_classes
        self.raw_size = raw_size
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def raw_hw(self) -> Tuple[int, int]:
        return self.raw_size, self.raw_size

    def _load_one(self, idx: int) -> np.ndarray:
        return decode_standardized(self.samples[idx][0], self.raw_size)

    def get_batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        images = np.stack(list(self._pool.map(self._load_one, indices)))
        labels = np.asarray([self.samples[i][1] for i in indices], np.int32)
        return images, labels


class FolderSource(FileListSource):
    """ImageFolder-style tree: <root>/<class_name>/<image files> (the layout
    torchvision.datasets.ImageFolder consumes, reference datasets.py:120-124).
    """

    def __init__(self, root: str, raw_size: int = 256, num_workers: int = 8):
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"No class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))
        super().__init__(samples, len(classes), raw_size, num_workers)


def _first_dir(*candidates: str) -> str:
    for c in candidates:
        if os.path.isdir(c):
            return c
    raise FileNotFoundError(f"none of {candidates} exists")


def flowers_source(root: str, is_train: bool, raw_size: int,
                   num_workers: int) -> FileListSource:
    """Oxford Flowers-102 in torchvision.datasets.Flowers102's layout
    (reference datasets.py:110-117, split train/val):
    <root>/flowers-102/jpg/image_%05d.jpg plus ``imagelabels.mat`` (key
    'labels') and ``setid.mat`` (keys 'trnid'/'valid'), both 1-indexed."""
    from scipy.io import loadmat

    base = _first_dir(os.path.join(root, "flowers-102"), root)
    labels = np.atleast_1d(loadmat(os.path.join(base, "imagelabels.mat"),
                                   squeeze_me=True)["labels"])
    setid = loadmat(os.path.join(base, "setid.mat"), squeeze_me=True)
    ids = np.atleast_1d(setid["trnid" if is_train else "valid"])
    samples = [(os.path.join(base, "jpg", f"image_{int(i):05d}.jpg"),
                int(labels[int(i) - 1]) - 1) for i in ids]
    return FileListSource(samples, DATASET_STATS["flowers"]["num_classes"],
                          raw_size, num_workers)


def stanford_cars_source(root: str, is_train: bool, raw_size: int,
                         num_workers: int) -> FileListSource:
    """Stanford Cars in torchvision.datasets.StanfordCars's layout (reference
    datasets.py:96-103, split train/test): <root>/stanford_cars/ with
    ``devkit/cars_train_annos.mat`` + ``cars_train/`` for train and
    ``cars_test_annos_withlabels.mat`` + ``cars_test/`` for test; the
    annotations are a struct array with 'fname' and 1-indexed 'class'."""
    from scipy.io import loadmat

    base = _first_dir(os.path.join(root, "stanford_cars"), root)
    if is_train:
        annos_path = os.path.join(base, "devkit", "cars_train_annos.mat")
        img_dir = os.path.join(base, "cars_train")
    else:
        annos_path = os.path.join(base, "cars_test_annos_withlabels.mat")
        img_dir = os.path.join(base, "cars_test")
    annotations = loadmat(annos_path, squeeze_me=True)["annotations"]
    samples = [(os.path.join(img_dir, str(a["fname"])), int(a["class"]) - 1)
               for a in np.atleast_1d(annotations)]
    return FileListSource(samples, DATASET_STATS["stanford_cars"]["num_classes"],
                          raw_size, num_workers)


def caltech256_source(root: str, raw_size: int,
                      num_workers: int) -> FileListSource:
    """Caltech-256 in torchvision.datasets.Caltech256's layout (reference
    datasets.py:104-109): <root>/caltech256/256_ObjectCategories/<cat>/<img>.
    Targets index the sorted category list; there is no train/val split, so
    the same set serves both, as in torchvision and the reference."""
    base = _first_dir(os.path.join(root, "caltech256", "256_ObjectCategories"),
                      os.path.join(root, "256_ObjectCategories"))
    categories = sorted(d for d in os.listdir(base)
                        if os.path.isdir(os.path.join(base, d)))
    num_classes = DATASET_STATS["caltech256"]["num_classes"]
    if len(categories) > num_classes:
        # The archive ships 257 dirs ('257.clutter' among them) where the
        # registry declares 256 classes: label 256 would crash the 256-way CE.
        raise ValueError(
            f"caltech256: found {len(categories)} category dirs under {base} "
            f"but DATASET_STATS['caltech256'] declares {num_classes} classes. "
            f"Remove the extra directories (typically '257.clutter') or adjust "
            f"the registry.")
    samples: List[Tuple[str, int]] = []
    for idx, cat in enumerate(categories):
        cdir = os.path.join(base, cat)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMG_EXTENSIONS):
                samples.append((os.path.join(cdir, fname), idx))
    return FileListSource(samples, num_classes, raw_size, num_workers)


def build_source(cfg, is_train: bool):
    """Dataset-name dispatch (reference dataset/datasets.py:86-124)."""
    name = cfg.dataset
    if name == "synthetic" or cfg.synthetic_data:
        num_classes = DATASET_STATS.get(name, DATASET_STATS["synthetic"])["num_classes"]
        hw = 32 if cfg.input_size <= 64 else cfg.input_size
        return synthetic_source(n=2048 if is_train else 512, hw=hw,
                                num_classes=num_classes, seed=0 if is_train else 1)
    if name.startswith("cifar"):
        return cifar_source(cfg.data_path, name, is_train)
    split = "train" if is_train else "val"
    # The eval transform resizes to input_size / eval_crop_ratio before its
    # center crop (reference dataset/datasets.py:76-80), so the host canvas
    # is at least that large.
    raw_size = max(256, int(round(cfg.input_size / cfg.eval_crop_ratio)))
    # the torchvision archive layouts first, then ImageFolder trees
    native = {
        "flowers": lambda: flowers_source(cfg.data_path, is_train, raw_size,
                                          cfg.num_workers),
        "stanford_cars": lambda: stanford_cars_source(
            cfg.data_path, is_train, raw_size, cfg.num_workers),
        "caltech256": lambda: caltech256_source(cfg.data_path, raw_size,
                                                cfg.num_workers),
    }
    if name in native:
        try:
            return native[name]()
        except (FileNotFoundError, ImportError):
            pass  # no native archive (or no scipy for the .mat readers)
    candidates = [
        os.path.join(cfg.data_path, split),
        os.path.join(cfg.data_path, name, split),
        os.path.join(cfg.data_path, name),
        cfg.data_path,
    ]
    for c in candidates:
        if os.path.isdir(c) and any(
                os.path.isdir(os.path.join(c, d)) for d in os.listdir(c)):
            try:
                return FolderSource(c, raw_size=raw_size, num_workers=cfg.num_workers)
            except FileNotFoundError:
                continue
    raise FileNotFoundError(
        f"Could not locate dataset '{name}' under {cfg.data_path} "
        f"(tried {candidates})")
