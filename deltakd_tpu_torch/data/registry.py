"""Dataset statistics (mean, std, class count), as in
``deltakd_tpu/data/registry.py``."""

DATASET_STATS = {
    "cifar-100": {
        "mean": (0.5071, 0.4867, 0.4408),
        "std": (0.2675, 0.2565, 0.2761),
        "num_classes": 100,
    },
    "cifar-10": {
        "mean": (0.4914, 0.4822, 0.4465),
        "std": (0.2023, 0.1994, 0.2010),
        "num_classes": 10,
    },
    "imagenet-1k": {
        "mean": (0.485, 0.456, 0.406),
        "std": (0.229, 0.224, 0.225),
        "num_classes": 1000,
    },
    "imagenet-21k": {
        "mean": (0.485, 0.456, 0.406),
        "std": (0.229, 0.224, 0.225),
        "num_classes": 21843,
    },
    "stanford_cars": {
        "mean": (0.4707, 0.4601, 0.4549),
        "std": (0.2767, 0.2760, 0.2850),
        "num_classes": 196,
    },
    "caltech256": {
        "mean": (0.485, 0.456, 0.406),
        "std": (0.229, 0.224, 0.225),
        "num_classes": 256,
    },
    "flowers": {
        "mean": (0.4489, 0.4180, 0.3176),
        "std": (0.2605, 0.2506, 0.2792),
        "num_classes": 102,
    },
    "synthetic": {
        "mean": (0.5, 0.5, 0.5),
        "std": (0.25, 0.25, 0.25),
        "num_classes": 100,
    },
}
