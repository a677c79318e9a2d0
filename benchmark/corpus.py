"""The bulk cells' corpus: smooth-field JPEGs in a store, laid out as the
builder's canonical source layout.

``smooth_field`` is the benchmark's copy of the bulk drive's generator: a
coarse random field upsampled bilinearly, plus a per-pixel dither, like a
photograph of a smooth scene rather than pure noise (noise is the JPEG
decoder's worst case). Set-up encodes a small pool of distinct JPEGs and
lists them under as many image keys as the run needs; each image key gets
its own points.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


def smooth_field(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """One (h, w, 3) uint8 image: an (h // 32, w // 32) random field
    upsampled bilinearly, plus a dither in [-12, 12] shared by the
    channels."""
    from PIL import Image

    base = rng.integers(0, 256, size=(h // 32, w // 32, 3), dtype=np.uint8)
    arr = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR),
                     dtype=np.int16)
    dither = rng.integers(-12, 13, size=(h, w, 1), dtype=np.int16)
    return np.clip(arr + dither, 0, 255).astype(np.uint8)


def encode_jpeg(image: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, by Pillow."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


@dataclass(frozen=True)
class CorpusImage:
    source_id: str
    image_id: str
    key: str
    h: int
    w: int
    rowcols: np.ndarray  # (P, 2) int32


class Corpus:
    """A pool of JPEGs and the sources laid out over it.

    ``traffic`` is a bulk mix file: ``image_sizes`` ([h, w], taken in
    turn), ``points_per_image``, ``jpeg_pool`` (distinct JPEGs, a multiple
    of the sizes), ``jpeg_quality``. The draws come from ``seed``: the
    same seed gives the same bytes and points."""

    def __init__(self, traffic: dict, seed: int, store, bucket: str = "imgs"):
        self.traffic = traffic
        self.store = store
        self.bucket = bucket
        self.sizes = [tuple(s) for s in traffic["image_sizes"]]
        n_pool = int(traffic["jpeg_pool"])
        if n_pool % len(self.sizes):
            raise ValueError("jpeg_pool must be a multiple of the image sizes")
        self.rng = np.random.default_rng(int(seed))
        self.pool = [encode_jpeg(smooth_field(self.rng, *self.sizes[i % len(self.sizes)]),
                                 int(traffic["jpeg_quality"]))
                     for i in range(n_pool)]
        self.images: dict[str, list[CorpusImage]] = {}
        self._next = 0

    def add_source(self, source_id: str, n_images: int) -> list[CorpusImage]:
        """Lay out ``n_images`` more images under ``s{source_id}``: the
        images' keys, the pool's bytes under them, and annotations.csv."""
        points = int(self.traffic["points_per_image"])
        images = []
        lines = ["image_id,image_key,row,col"]
        for _ in range(n_images):
            g = self._next
            self._next += 1
            h, w = self.sizes[g % len(self.sizes)]
            image_id = f"{g:06d}"
            key = f"s{source_id}/images/i{image_id}.jpg"
            self.store.put_bytes(self.bucket, key, self.pool[g % len(self.pool)])
            rowcols = np.stack([self.rng.integers(0, h, size=points),
                                self.rng.integers(0, w, size=points)],
                               axis=1).astype(np.int32)
            lines.extend(f"{image_id},{key},{r},{c}" for r, c in rowcols)
            images.append(CorpusImage(source_id, image_id, key, h, w, rowcols))
        self.store.put_bytes(self.bucket, f"s{source_id}/annotations.csv",
                             ("\n".join(lines) + "\n").encode())
        self.images[source_id] = images
        return images
