"""Paired before/after image folders for image sliders (port of
sliders_tpu/data/paired_images.py).

The reference's data contract (train_lora-scale.py:211-220): per-scale
folders under a main folder (`--folders 'bigsize,smallsize' --scales '1,-1'`);
each iteration picks a scale s, pairs the folder at -s with the folder at
+s, and reads the SAME filename from both, resized to the train resolution
by `data/native_loader.load_batch` (no Pillow). `sample_pair` makes the
JAX class's `numpy.random.Generator` calls in the same order, so one seed
draws the same (scale, filename) sequence in both packages.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from sliders_tpu_torch.data import native_loader

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")

logger = logging.getLogger(__name__)


@dataclass
class PairedImageFolders:
    folder_main: str
    folders: list  # aligned with scales
    scales: list
    _bad_files: set = field(default_factory=set, repr=False)

    def __post_init__(self):
        if len(self.folders) != len(self.scales):
            raise ValueError("folders and scales must align")
        self.scales_unique = sorted({abs(s) for s in self.scales if s != 0})
        self._by_scale = {s: f for s, f in zip(self.scales, self.folders)}
        for s in self.scales_unique:
            if s not in self._by_scale or -s not in self._by_scale:
                raise ValueError(f"need folders for both +{s} and -{s}")

    def filenames(self, scale: float) -> list:
        d = os.path.join(self.folder_main, self._by_scale[scale])
        return sorted(f for f in os.listdir(d) if f.lower().endswith(IMAGE_EXTS))

    def sample_pair(self, rng: np.random.Generator, resolution: int):
        """Returns (scale, low_image, high_image): the same filename from the
        -scale and +scale folders, each (res, res, 3) float32 in [-1, 1].

        A malformed or missing file is skipped with a warning and a fresh
        filename is drawn (the reference tolerates bad images mid-run,
        train_lora-scale-xl.py:261-286); a filename that failed once is
        excluded for the rest of the run, and a scale with no readable pair
        left raises RuntimeError. A JPEG that cannot be decoded here for
        want of g++ or libjpeg (`native_loader.JpegUnavailable`) is not a
        bad file: it stops the run."""
        s = float(rng.choice(self.scales_unique))
        names = [n for n in self.filenames(-s) if (s, n) not in self._bad_files]
        while names:
            name = names[int(rng.integers(len(names)))]
            try:
                return (s, *self._load_pair(s, name, resolution))
            except (OSError, ValueError) as e:
                logger.warning("skipping unreadable image pair %r (scale %s): %s", name, s, e)
                self._bad_files.add((s, name))
                names.remove(name)
        raise RuntimeError(f"no decodable image pairs left for scale {s} under {self.folder_main}")

    def _load_pair(self, s: float, name: str, resolution: int):
        lo_path = os.path.join(self.folder_main, self._by_scale[-s], name)
        hi_path = os.path.join(self.folder_main, self._by_scale[s], name)
        lo, hi = native_loader.load_batch([lo_path, hi_path], resolution)
        return lo, hi


def parse_folder_args(folders: str, scales: str) -> tuple:
    """Reference CLI format: comma-separated strings
    (train_lora-scale.py:420-443)."""
    fs = [f.strip() for f in folders.split(",")]
    ss = [float(s.strip()) for s in scales.split(",")]
    if len(fs) != len(ss):
        raise ValueError("the number of folders need to match the number of scales")
    return fs, ss
