"""Bulk extraction: sources of JPEGs in a store, through the port's
``FeatureBucketBuilder.run``, into feature files in a target store.

Set-up makes the backbone's weights from the seed, builds the extractor as
the bulk CLI does, lays the corpus out (``benchmark/corpus.py``) and runs a
small warm source with the numerics gate, which warms every shape the
window uses (the three image sizes, the trunk's two chunk sizes). The
window runs one source after another, each into a fresh target bucket,
until ``--seconds`` have passed; it spans whole calls.

The check, once the window has closed and the program is released: every
image due in the window has a feature file in the target store. Set-up
draws from the seed ``check_per_call`` images of every call the window
may make; the store keeps those files' bytes (and only the sizes of the
others). Each kept file of a call that was due must hold the annotated
``rowcols`` and a finite (points, feature_dim) ``features``, and for
``check_images`` of them, drawn from the seed, the features must match the
plain reference's, computed from the JPEG bytes by its own decode, crop
and f32 forward.
"""

from __future__ import annotations

import io
import sys
import time

import numpy as np
import torch

from benchmark import compare, costs, weights
from benchmark.corpus import Corpus, decode_jpeg
from benchmark.reference.efficientnet import EfficientNet, crop
from benchmark.spans import Spans
from benchmark.store import MemoryObjectStore
from mermaid_classifier_tpu_torch.data.feature_bucket import (
    FeatureBucketBuilder,
    feature_key,
)
from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
from mermaid_classifier_tpu_torch.models.extractor import FeatureExtractor
from mermaid_classifier_tpu_torch.serve.image_sources import decode_image_bytes

SPAN_NAMES = ("decode", "dispatch")
MAX_CALLS = 1000  # more sources than any window can run


class _TimedExtractor:
    """The extractor as the builder sees it, with its dispatch timed."""

    def __init__(self, extractor, spans: Spans):
        self._extractor = extractor
        self._dispatch = spans.wrap("dispatch", extractor.extract_features_async)

    def extract_features_async(self, image, rowcols):
        return self._dispatch(image, rowcols)

    def verify_device_numerics(self, *args, **kwargs):
        return self._extractor.verify_device_numerics(*args, **kwargs)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, trace: bool):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.trace = trace
        self.spans = Spans(enabled=trace)
        self.calls: list[tuple[str, str]] = []  # (target bucket, source id)
        self.record: dict = {}

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        cfg, tr = self.config, self.traffic
        backbone = cfg["backbone"]
        self.variables = weights.backbone_variables(backbone, cfg["init"], self.seed,
                                                    self.device)
        extractor = FeatureExtractor(self.variables, EfficientNetConfig.from_dict(backbone),
                                     device=self.device, **cfg["extractor"])
        self.extractor = _TimedExtractor(extractor, self.spans) if self.trace else extractor
        self.decode = self.spans.wrap("decode", decode_image_bytes) if self.trace else None
        self.store = MemoryObjectStore(keep=self._keep)
        self.corpus = Corpus(tr, self.seed, self.store)
        self.corpus.add_source("warm", int(tr["warm_images"]))
        self.sources = [str(s) for s in range(1, int(tr["sources"]) + 1)]
        for sid in self.sources:
            self.corpus.add_source(sid, int(tr["images_per_source"]))
        if self.trace:
            self.corpus.add_source("trace", int(tr["trace_images"]))
        rng = np.random.default_rng([self.seed, 0xC4EC])
        per_call, n_images = int(tr["check_per_call"]), int(tr["images_per_source"])
        self.kept = set()
        for k in range(MAX_CALLS):
            images = self.corpus.images[self.sources[k % len(self.sources)]]
            for i in rng.choice(n_images, size=per_call, replace=False):
                self.kept.add((f"out{k:05d}", feature_key(images[i].source_id,
                                                          images[i].image_id)))
        self._run("warm", "out-warm", verify=cfg["builder"]["verify_numerics"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _keep(self, bucket: str, key: str) -> bool:
        return not key.endswith(".features.npz") or (bucket, key) in self.kept

    def _run(self, source_id: str, target: str, verify: bool = False):
        builder = FeatureBucketBuilder(
            self.store, self.corpus.bucket, target, self.extractor,
            decode_image=self.decode,
            decode_workers=self.config["builder"]["decode_workers"],
            prefetch=self.config["builder"]["prefetch"])
        return builder.run([source_id], verify_numerics=verify).sources[0]

    # -- the window -----------------------------------------------------

    def window(self, seconds: float) -> dict:
        patches = attempted = failed = 0
        t0 = time.perf_counter()
        while True:
            k = len(self.calls)
            sid = self.sources[k % len(self.sources)]
            target = f"out{k:05d}"
            t_call = time.perf_counter()
            result = self._run(sid, target)
            self.calls.append((target, sid))
            print(f"window call {k}: source {sid}, {result.images_done} images in"
                  f" {time.perf_counter() - t_call:.3f} s", file=sys.stderr)
            patches += result.points_done
            attempted += result.images_total
            failed += result.images_failed
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        backbone = self.config["backbone"]
        self.record.update(
            window_s=elapsed, patches=patches, spans=dict(self.spans.ms),
            flops_per_patch=costs.trunk_flops_per_patch(backbone),
            peak_flops=costs.PEAK_FLOPS[backbone["compute_dtype"]])
        return {"metrics": {"bulk_patches_per_s": patches / elapsed},
                "attempted": attempted, "failed": failed}

    # -- the profiled stretch (--trace 1) ---------------------------------

    def stretch(self) -> None:
        """One more source, of ``trace_images`` images, under the profiler."""
        self._run("trace", "out-trace")

    def stretch_work(self) -> dict:
        """The work the stretch's launches had to do, by the benchmark's
        count: one crop per image; every fused-route block over the
        image's patches."""
        backbone = self.config["backbone"]
        dtype = backbone["compute_dtype"]
        ps = backbone["patch_size"]
        fused = [b for b in costs.blocks(backbone) if b.fusable]
        crop_w, fused_w = [], []
        for img in self.corpus.images["trace"]:
            crop_w.append(costs.crop_work(img.h, img.w, img.rowcols, ps, dtype))
            fused_w += [costs.fused_block_work(len(img.rowcols), b, dtype) for b in fused]
        return {"crop": crop_w, "fused_mbconv": fused_w}

    # -- after the window -----------------------------------------------

    def release(self) -> None:
        self.extractor = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self) -> dict:
        tr, backbone = self.traffic, self.config["backbone"]
        bad = 0
        kept = []
        for target, sid in self.calls:
            for img in self.corpus.images[sid]:
                key = feature_key(img.source_id, img.image_id)
                if not self.store.exists(target, key) or self.store.size(target, key) == 0:
                    bad += 1
                elif (target, key) in self.kept:
                    kept.append((target, img))
        files = []
        for target, img in kept:
            data = self.store.get_bytes(target, feature_key(img.source_id, img.image_id))
            try:
                with np.load(io.BytesIO(data), allow_pickle=False) as npz:
                    rowcols, features = npz["rowcols"], npz["features"]
            except (OSError, ValueError, KeyError):
                bad += 1
                continue
            if (not np.array_equal(rowcols, img.rowcols)
                    or features.shape != (len(img.rowcols), backbone["feature_dim"])
                    or not np.isfinite(features).all()):
                bad += 1
            else:
                files.append((img, features))
        rng = np.random.default_rng([self.seed, 0x5A3F])
        n = min(int(tr["check_images"]), len(files))
        sample = [files[i] for i in sorted(rng.choice(len(files), size=n, replace=False))]
        reference = EfficientNet(self.variables, backbone, self.device)
        self.compared = {"images": [img for img, _ in sample],
                         "got": [features for _, features in sample],
                         "want": [reference.features(self.patches(img)).numpy()
                                  for img, _ in sample]}
        return {"bad_files": bad,
                "feature_gap": compare.feature_gap(self.compared["got"], self.compared["want"])}

    def patches(self, img) -> torch.Tensor:
        """The reference's own decode and crop of one image's points."""
        backbone = self.config["backbone"]
        pixels = decode_jpeg(self.store.get_bytes(self.corpus.bucket, img.key))
        return crop(pixels, img.rowcols, backbone["patch_size"], backbone["mean_rgb"],
                    backbone["std_rgb"])
