"""Image acquisition: one injectable fetcher covering local paths,
object-store URIs and CoralNet image IDs.

The port's own copy of ``mermaid_classifier_tpu/serve/image_sources.py``.
The CoralNet transport is an injectable callable, so offline environments
(and tests) supply a fake while the structure (ID resolution,
suffix-preserving cache, page scrape) stays production-shaped.

Decoding: bytes that start with the ``.npy`` magic are read by numpy as a
(H, W, 3) uint8 array; anything else is decoded by Pillow, which is imported
inside the decode call only, so the package imports without it.
"""

from __future__ import annotations

import io
import re
import urllib.request
from html.parser import HTMLParser
from logging import getLogger
from pathlib import Path
from typing import Callable
from urllib.parse import urlparse

import numpy as np

logger = getLogger(__name__)

CORALNET_IMAGE_VIEW_URL = "https://coralnet.ucsd.edu/image/{image_id}/view/"
_NPY_MAGIC = b"\x93NUMPY"


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB."""
    if data[: len(_NPY_MAGIC)] == _NPY_MAGIC:
        image = np.load(io.BytesIO(data), allow_pickle=False)
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(
                f"a .npy image must be (H, W, 3) uint8, got {image.shape}"
                f" {image.dtype}"
            )
        return image
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


class _OriginalImageParser(HTMLParser):
    """Pull the <img src> inside div#original_image_container."""

    def __init__(self) -> None:
        super().__init__()
        self._in_container = 0
        self.image_url: str | None = None

    def handle_starttag(self, tag, attrs):
        attrs = dict(attrs)
        if tag == "div":
            if attrs.get("id") == "original_image_container":
                self._in_container = 1
            elif self._in_container:
                self._in_container += 1
        elif tag == "img" and self._in_container and self.image_url is None:
            self.image_url = attrs.get("src")

    def handle_endtag(self, tag):
        if tag == "div" and self._in_container:
            self._in_container -= 1


def scrape_coralnet_image(
    image_id: int, timeout_s: float = 60.0
) -> tuple[bytes, str]:
    """Default CoralNet transport: image-view page -> original image URL ->
    (bytes, file suffix). Needs network egress; inject a fake where there
    is none. Bounded timeouts: a stalled connection errors instead of
    hanging the run."""
    view_url = CORALNET_IMAGE_VIEW_URL.format(image_id=image_id)
    with urllib.request.urlopen(view_url, timeout=timeout_s) as response:
        parser = _OriginalImageParser()
        parser.feed(response.read().decode("utf-8", errors="replace"))
    if not parser.image_url:
        raise ValueError(
            f"CoralNet image {image_id}: the image-view page has no original"
            " image element — possibly a private source."
        )
    suffix = Path(urlparse(parser.image_url).path).suffix or ".jpg"
    logger.info("downloading CoralNet image %d ...", image_id)
    with urllib.request.urlopen(parser.image_url, timeout=timeout_s) as response:
        return response.read(), suffix


class ImageFetcher:
    """Resolve an image spec to a decoded RGB array.

    Spec forms:
    - a local file path (an existing file always wins, even when its name
      is all digits);
    - ``store://<bucket>/<key>``, fetched through the object store;
    - an integer (or an all-digits string naming no existing file): a
      CoralNet image ID, resolved through the cache dir first, then the
      injectable transport.
    """

    def __init__(
        self,
        *,
        store=None,
        cache_dir: str | Path | None = None,
        coralnet_transport: Callable[[int], tuple[bytes, str]] | None = None,
    ) -> None:
        self._store = store
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self._coralnet_transport = coralnet_transport or scrape_coralnet_image

    def fetch(self, spec: str | int | Path) -> np.ndarray:
        # An existing local file always wins over the CoralNet-ID reading
        # of an all-digits spec: a digit-named file must never trigger a
        # network scrape.
        if isinstance(spec, int) or (
            re.fullmatch(r"\d+", str(spec)) and not Path(str(spec)).is_file()
        ):
            return self._fetch_coralnet(int(spec))
        spec = str(spec)
        if re.fullmatch(r"\d+", spec):
            logger.info(
                "spec %r matches a local file in %s; serving the file, NOT"
                " CoralNet image %s",
                spec, Path.cwd(), spec,
            )
        if spec.startswith("store://"):
            rest = spec[len("store://"):]
            bucket, _, key = rest.partition("/")
            store = self._store
            if store is None:
                from mermaid_classifier_tpu_torch.data.store import (
                    get_default_store,
                )

                store = get_default_store()
            return decode_image_bytes(store.get_bytes(bucket, key))
        return decode_image_bytes(Path(spec).read_bytes())

    def _fetch_coralnet(self, image_id: int) -> np.ndarray:
        # Cache first: any suffix under i<id>.* (the suffix is only known
        # after scraping, so the lookup is by stem).
        if self.cache_dir is not None and self.cache_dir.is_dir():
            for path in sorted(self.cache_dir.iterdir()):
                if path.stem == f"i{image_id}":
                    logger.info("CoralNet image %d found in cache", image_id)
                    return decode_image_bytes(path.read_bytes())
        data, suffix = self._coralnet_transport(image_id)
        if self.cache_dir is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
            (self.cache_dir / f"i{image_id}{suffix}").write_bytes(data)
        return decode_image_bytes(data)
