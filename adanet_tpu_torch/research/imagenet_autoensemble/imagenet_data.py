"""ImageNet-format input pipeline (local directory, no egress).

Loads the standard extracted-ImageNet folder layout

    data_dir/train/<class_name>/*.JPEG
    data_dir/val/<class_name>/*.JPEG

(class names are the sorted train subdirectories; `val` falls back to
`validation` or `test`). Decoding uses PIL; augmentation follows the
standard ImageNet recipe the reference's slim-based models were trained
with (reference: research/improve_nas/trainer/nasnet.py consumes
slim-preprocessed 224/331 inputs): random-resized crop + horizontal flip
for training, resize-shorter-side + center crop for eval, then per-channel
standardization with the published ImageNet statistics.

Same iterator protocol as the CIFAR providers
(research/improve_nas/trainer/cifar10.py): `get_input_fn(partition)`
returns a zero-arg callable yielding `({"image": float32 NHWC}, labels)`
batches with static shapes (remainder dropped), reshuffled per epoch,
deterministic given (seed, epoch count).

`SyntheticProvider` is the no-data stand-in: class-conditional colored
noise images with the same interface, learnable by any conv model — the
convergence-gate data for tests and the `--dataset=fake` trainer path.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)

_EXTENSIONS = (".jpeg", ".jpg", ".png", ".bmp")


def _list_images(class_dir: str) -> List[str]:
    return sorted(
        os.path.join(class_dir, f)
        for f in os.listdir(class_dir)
        if f.lower().endswith(_EXTENSIONS)
    )


class Provider:
    """ImageNet-folder batches with standard augmentation."""

    def __init__(
        self,
        data_dir: str,
        batch_size: int = 32,
        image_size: int = 224,
        seed: int = 42,
    ):
        self._data_dir = data_dir
        self._batch_size = batch_size
        self._image_size = image_size
        self._seed = seed
        self._index_cache = {}
        train_dir = os.path.join(data_dir, "train")
        if not os.path.isdir(train_dir):
            raise FileNotFoundError(
                "ImageNet train directory not found: %s (expected the "
                "standard extracted layout train/<class>/*.JPEG; this "
                "environment has no network egress)" % train_dir
            )
        self._class_names = sorted(
            d
            for d in os.listdir(train_dir)
            if os.path.isdir(os.path.join(train_dir, d))
        )
        if not self._class_names:
            raise FileNotFoundError(
                "no class subdirectories under %s" % train_dir
            )

    @property
    def num_classes(self) -> int:
        return len(self._class_names)

    @property
    def class_names(self) -> List[str]:
        return list(self._class_names)

    def _partition_dir(self, partition: str) -> str:
        if partition == "train":
            return os.path.join(self._data_dir, "train")
        for name in ("val", "validation", "test"):
            cand = os.path.join(self._data_dir, name)
            if os.path.isdir(cand):
                return cand
        raise FileNotFoundError(
            "no val/validation/test directory under %s" % self._data_dir
        )

    def _index(self, partition: str) -> Tuple[List[str], np.ndarray]:
        """(paths, labels), labels indexed by the TRAIN class order."""
        if partition in self._index_cache:
            return self._index_cache[partition]
        base = self._partition_dir(partition)
        label_of = {name: i for i, name in enumerate(self._class_names)}
        paths, labels = [], []
        for name in sorted(os.listdir(base)):
            class_dir = os.path.join(base, name)
            if not os.path.isdir(class_dir) or name not in label_of:
                continue
            files = _list_images(class_dir)
            paths.extend(files)
            labels.extend([label_of[name]] * len(files))
        if not paths:
            raise FileNotFoundError("no images under %s" % base)
        out = (paths, np.asarray(labels, np.int32))
        self._index_cache[partition] = out
        return out

    def _decode_train(self, path: str, rng: np.random.RandomState):
        """Random-resized crop (area 8-100%, aspect 3/4-4/3) + flip."""
        from PIL import Image

        size = self._image_size
        with Image.open(path) as img:
            img = img.convert("RGB")
            w, h = img.size
            for _ in range(10):
                area = w * h * rng.uniform(0.08, 1.0)
                ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw = int(round(np.sqrt(area * ratio)))
                ch = int(round(np.sqrt(area / ratio)))
                if 0 < cw <= w and 0 < ch <= h:
                    x0 = rng.randint(0, w - cw + 1)
                    y0 = rng.randint(0, h - ch + 1)
                    img = img.crop((x0, y0, x0 + cw, y0 + ch))
                    break
            else:  # fallback: center crop of the shorter side
                side = min(w, h)
                x0, y0 = (w - side) // 2, (h - side) // 2
                img = img.crop((x0, y0, x0 + side, y0 + side))
            img = img.resize((size, size), Image.BILINEAR)
            arr = np.asarray(img, np.float32) / 255.0
        if rng.rand() < 0.5:
            arr = arr[:, ::-1]
        return arr

    def _decode_eval(self, path: str):
        """Resize shorter side to size*256/224 then center crop."""
        from PIL import Image

        size = self._image_size
        resize_to = max(size, int(round(size * 256 / 224)))
        with Image.open(path) as img:
            img = img.convert("RGB")
            w, h = img.size
            scale = resize_to / min(w, h)
            img = img.resize(
                (max(size, int(round(w * scale))),
                 max(size, int(round(h * scale)))),
                Image.BILINEAR,
            )
            w, h = img.size
            x0, y0 = (w - size) // 2, (h - size) // 2
            img = img.crop((x0, y0, x0 + size, y0 + size))
            return np.asarray(img, np.float32) / 255.0

    def _standardize(self, images: np.ndarray) -> np.ndarray:
        return (images - _MEAN) / _STD

    def get_input_fn(
        self,
        partition: str = "train",
        shuffle: Optional[bool] = None,
    ):
        if shuffle is None:
            shuffle = partition == "train"
        augment = partition == "train"
        epoch_counter = {"epoch": 0}

        def input_fn() -> Iterator:
            epoch = epoch_counter["epoch"]
            epoch_counter["epoch"] += 1
            paths, labels = self._index(partition)
            rng = np.random.RandomState(self._seed + epoch)
            order = np.arange(len(paths))
            if shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), self._batch_size):
                idx = order[start : start + self._batch_size]
                if len(idx) < self._batch_size:
                    return  # static shapes for XLA
                if augment:
                    batch = np.stack(
                        [self._decode_train(paths[i], rng) for i in idx]
                    )
                else:
                    batch = np.stack(
                        [self._decode_eval(paths[i]) for i in idx]
                    )
                yield (
                    {"image": self._standardize(batch)},
                    labels[idx],
                )

        return input_fn


class SyntheticProvider:
    """Class-conditional colored-noise images, ImageNet interface.

    Each class has a fixed random mean color + spatial frequency pattern;
    any conv model separates them quickly, making this the deterministic
    convergence-gate dataset for the ImageNet config (no egress here).
    """

    def __init__(
        self,
        num_classes: int = 8,
        num_examples: int = 256,
        batch_size: int = 32,
        image_size: int = 32,
        seed: int = 42,
    ):
        self.num_classes = num_classes
        self._batch_size = batch_size
        self._image_size = image_size
        self._seed = seed
        rng = np.random.RandomState(seed)
        # Class signatures: a mean color and a low-frequency template.
        colors = rng.uniform(-1.0, 1.0, size=(num_classes, 3))
        templates = rng.randn(num_classes, 4, 4, 3)
        self._data = {}
        for partition, n, s in (
            ("train", num_examples, 0),
            ("test", max(batch_size, num_examples // 4), 1),
        ):
            prng = np.random.RandomState(seed + 1000 * s + 1)
            labels = prng.randint(0, num_classes, size=n).astype(np.int32)
            base = templates[labels]
            scale = -(-image_size // 4)  # ceil: any image_size works
            up = base.repeat(scale, axis=1).repeat(scale, axis=2)[
                :, :image_size, :image_size
            ]
            images = (
                colors[labels][:, None, None, :]
                + 0.5 * up
                + 0.3 * prng.randn(n, image_size, image_size, 3)
            ).astype(np.float32)
            self._data[partition] = (images, labels)

    def get_input_fn(
        self, partition: str = "train", shuffle: Optional[bool] = None
    ):
        if shuffle is None:
            shuffle = partition == "train"
        epoch_counter = {"epoch": 0}

        def input_fn() -> Iterator:
            epoch = epoch_counter["epoch"]
            epoch_counter["epoch"] += 1
            images, labels = self._data[partition]
            rng = np.random.RandomState(self._seed + epoch)
            order = np.arange(len(images))
            if shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), self._batch_size):
                idx = order[start : start + self._batch_size]
                if len(idx) < self._batch_size:
                    return
                yield {"image": images[idx]}, labels[idx]

        return input_fn
