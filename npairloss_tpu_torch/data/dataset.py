"""Datasets: the MultibatchData list-file contract + in-memory arrays (a
copy of ``npairloss_tpu/data/dataset.py``; numpy, and PIL imported when
an image is loaded).

The reference's (external) MultibatchData layer reads ``root_folder`` +
``source`` — a text file of ``relative/path label`` lines — decodes and
resizes each image to ``new_height`` x ``new_width``
(usage/def.prototxt:17-24).  ``ListFileDataset`` reproduces that contract
on the host (PIL decode in the loader's prefetch thread); ``ArrayDataset``
serves in-memory arrays with the same interface for tests and synthetic
runs.  Both hand out host arrays; the loader uploads them to the device.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


class ListFileDataset:
    """``source`` list file of "path label" rows under ``root_folder``."""

    def __init__(
        self,
        root_folder: str,
        source: str,
        new_height: int = 0,
        new_width: int = 0,
    ):
        self.root = root_folder
        self.new_height = int(new_height)
        self.new_width = int(new_width)
        self.paths: List[str] = []
        labels: List[int] = []
        with open(source, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                # "path label"; paths may contain spaces — label is the
                # last whitespace-separated token (space or tab).
                parts = line.rsplit(None, 1)
                if len(parts) != 2:
                    raise ValueError(f"malformed list line: {line!r}")
                path, lbl = parts
                self.paths.append(path)
                labels.append(int(float(lbl)))
        self.labels = np.asarray(labels, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.paths)

    def load(self, index: int) -> np.ndarray:
        """Decode one image to uint8 RGB [new_h, new_w, 3]."""
        from PIL import Image

        path = os.path.join(self.root, self.paths[index])
        with Image.open(path) as im:
            im = im.convert("RGB")
            if self.new_height and self.new_width:
                im = im.resize(
                    (self.new_width, self.new_height), Image.BILINEAR
                )
            return np.asarray(im, dtype=np.uint8)

    def load_batch(self, indices: Sequence[int]) -> np.ndarray:
        return np.stack([self.load(int(i)) for i in indices])


class ArrayDataset:
    """In-memory images+labels with the ListFileDataset interface."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        assert len(images) == len(labels)
        self.images = images
        self.labels = np.asarray(labels, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.images)

    def load(self, index: int) -> np.ndarray:
        return self.images[index]

    def load_batch(self, indices: Sequence[int]) -> np.ndarray:
        return self.images[np.asarray(indices)]
