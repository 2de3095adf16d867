"""Synthetic video for the Hydro use cases.

Port of ``repro.data.video``: the same seed gives the same objects, frames
and crops as the JAX package's. ``SyntheticVideo`` plants colored "dog"
rectangles with known breed/color ground truth into random-noise frames,
so UC1/UC2 queries have exact expected answers (AQP must return the same
rows as naive evaluation — the paper's no-accuracy-tradeoff claim is
testable).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref as kref

BREEDS = ("great dane", "labrador retriever", "poodle", "beagle")
COLORS = ("black", "gray", "yellow", "white")

_COLOR_RGB = {
    "black": (10, 10, 10),
    "gray": (120, 120, 120),
    "yellow": (230, 210, 40),
    "white": (240, 240, 240),
}


@dataclass
class PlantedObject:
    frame_id: int
    label: str            # "dog" | "person" | ...
    breed: str
    color: str
    bbox: Tuple[int, int, int, int]  # x0, y0, x1, y1
    score: float


@dataclass
class SyntheticVideo:
    num_frames: int = 600
    height: int = 96
    width: int = 128
    seed: int = 0
    dog_rate: float = 0.7          # fraction of frames containing a dog
    breed_probs: Tuple[float, ...] = (0.25, 0.06, 0.39, 0.30)
    color_probs: Tuple[float, ...] = (0.35, 0.06, 0.29, 0.30)
    objects: List[PlantedObject] = field(default_factory=list)
    # frame id -> its objects, in planting order; frame() and detections()
    # read it instead of scanning every object of the video
    _by_frame: Dict[int, List[PlantedObject]] = field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        for f in range(self.num_frames):
            if rng.random() < self.dog_rate:
                breed = rng.choice(BREEDS, p=self.breed_probs)
                color = rng.choice(COLORS, p=self.color_probs)
                w = int(rng.integers(24, 56))
                h = int(rng.integers(24, 56))
                x0 = int(rng.integers(0, self.width - w))
                y0 = int(rng.integers(0, self.height - h))
                self.objects.append(
                    PlantedObject(f, "dog", str(breed), str(color),
                                  (x0, y0, x0 + w, y0 + h), 0.9)
                )
            if rng.random() < 0.3:
                self.objects.append(
                    PlantedObject(f, "person", "", "", (0, 0, 16, 16), 0.8)
                )
        for obj in self.objects:
            self._by_frame.setdefault(obj.frame_id, []).append(obj)

    def frame(self, frame_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, frame_id))
        img = rng.integers(60, 200, size=(self.height, self.width, 3)).astype(np.uint8)
        for obj in self._by_frame.get(frame_id, ()):
            if obj.label == "dog":
                x0, y0, x1, y1 = obj.bbox
                rgb = _COLOR_RGB[obj.color]
                img[y0:y1, x0:x1] = np.asarray(rgb, np.uint8)[None, None]
        return img

    def crop(self, frame_id: int, bbox) -> np.ndarray:
        x0, y0, x1, y1 = bbox
        return self.frame(frame_id)[y0:y1, x0:x1]

    def detections(self, frame_id: int) -> List[PlantedObject]:
        return list(self._by_frame.get(frame_id, ()))

    def ground_truth(self, breed: str, color: str) -> List[PlantedObject]:
        return [
            o for o in self.objects
            if o.label == "dog" and o.breed == breed and o.color == color
        ]


def crop_to_canonical(crop: np.ndarray, size: int = 64) -> np.ndarray:
    """Nearest-neighbour resize to a canonical square (shape bucketing)."""
    h, w = crop.shape[:2]
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    return crop[ys][:, xs]


def classify_color_batch(crops: np.ndarray) -> List[str]:
    """Ground-truth-free color labels via the plain HSV version (CPU)."""
    _, label = kref.hsv_color_classify(
        torch.from_numpy(np.ascontiguousarray(crops, dtype=np.float32)))
    return [kref.COLOR_NAMES[int(i)] for i in label.tolist()]
