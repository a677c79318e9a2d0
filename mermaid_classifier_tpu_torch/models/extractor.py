"""FeatureExtractor: decoded image + annotated points -> feature vectors.

Port of ``mermaid_classifier_tpu/models/extractor.py``. The weights are held
on one device, given explicitly (``device="cuda"`` or ``"cpu"``; there is no
"cuda if available"). Per image:

1. the raw image is uploaded once, with no padded copy: the ps//2 zero pad
   is folded into the crop. On CUDA the host fills a page-locked buffer
   from PyTorch's caching host allocator and queues a non-blocking copy
   from it: a copy from pageable memory waits for the stream to drain
   first, even with ``non_blocking=True``, so each image would wait for
   the previous image's trunk and the card would start it with nothing
   queued. The allocator records an event on the copy and hands the
   buffer out again only once the copy has landed;
2. the point list is padded to a multiple of ``point_bucket`` by duplicating
   point 0, and every patch is cropped and normalized on the device by the
   crop kernel (``ops/patch_crop.py``, ``pad = ps // 2``: zeros outside the
   image) in the trunk's compute dtype; the padding points are trimmed;
3. the trunk runs over chunks of ``backbone_batch`` patches, a Python loop
   (PyTorch runs eagerly, so the last chunk keeps its own size).

``extract_features_async`` is the bulk path's hand-off: it dispatches one
image, queues a non-blocking copy of its features into pinned host memory
and records an event after it. ``FeatureReadback.wait`` waits on that event
alone, so a reader on another thread gets this image's features while the
next image, queued behind it on the same stream, keeps running (a plain
``.cpu()`` there would wait for the whole stream).

``backbone_impl`` picks the trunk: ``"fused"`` (default: folded weights, the
fused-MBConv kernel for every fusable block), ``"folded"`` (folded weights,
plain PyTorch blocks) or ``"module"`` (the ``nn.Module`` forward, the
counterpart of the JAX package's ``"flax"``). The JAX default "folded" was a
TPU measurement; the port's default is the path that runs its kernels.

With a ``mesh`` (``parallel.mesh``; every rank is given the same images) the
trunk runs data-parallel, ``folded`` or ``module`` (``fused`` is
single-device, as in JAX): an image's points pad to a multiple of
``backbone_batch`` (which the mesh size must divide), each chunk of
``backbone_batch`` points splits into one contiguous share per rank, each
rank crops only its shares with the crop kernel (one launch per image) and
runs them through its replica of the trunk, and one all-gather gives every
rank every feature, in point order.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any

import numpy as np
import torch

from mermaid_classifier_tpu_torch.models.efficientnet import (
    EfficientNetBackbone,
    EfficientNetConfig,
    compute_dtype,
    init_backbone_params,
    load_jax_variables,
)
from mermaid_classifier_tpu_torch.ops import fused_mbconv
from mermaid_classifier_tpu_torch.ops.patch_crop import extract_patches
from mermaid_classifier_tpu_torch.ops.patch_ops import channel_scale_bias
from mermaid_classifier_tpu_torch.utils import profiling

BACKBONE_IMPLS = ("module", "folded", "fused")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DeviceNumericsError(RuntimeError):
    """The configured backbone diverges from the f32 CPU reference beyond
    the cosine-similarity gate."""


def _resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is"
            " False"
        )
    return device


def stage(image: np.ndarray, out: torch.Tensor) -> torch.Tensor:
    """Fill the contiguous uint8 CPU tensor ``out``, of the image's shape,
    from ``image`` in one pass, with the cast and layout of
    ``np.ascontiguousarray(image, dtype=np.uint8)``. Returns ``out``."""
    np.copyto(out.numpy(), image, casting="unsafe")
    return out


def _module_forward(variables, config: EfficientNetConfig, device):
    dtype = compute_dtype(config)
    module = EfficientNetBackbone(config)
    load_jax_variables(module, variables)
    module = module.to(device=device, dtype=dtype).eval()

    def forward(patches: torch.Tensor) -> torch.Tensor:
        with fused_mbconv.full_f32():
            return module(patches)

    return forward


class FeatureReadback:
    """One image's (P, D) float32 features on their way to the host: the
    host tensor a copy is queued into, and the CUDA event recorded after
    the copy (None when the features were computed on the CPU)."""

    def __init__(self, host: torch.Tensor, event: torch.cuda.Event | None = None):
        self._host = host
        self._event = event

    def wait(self) -> np.ndarray:
        """The features as a numpy array, once their copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class FeatureExtractor:
    """Cached-backbone batched point-feature extractor."""

    def __init__(
        self,
        variables: Any,
        config: EfficientNetConfig | None = None,
        *,
        device,
        backbone_batch: int = 128,
        point_bucket: int = 32,
        image_bucket: int = 256,
        backbone_impl: str = "fused",
        mesh: Any = None,
    ) -> None:
        self.config = config or EfficientNetConfig()
        self.device = _resolve_device(device)
        self.variables = variables
        self.backbone_batch = int(backbone_batch)
        self.point_bucket = int(point_bucket)
        self.image_bucket = int(image_bucket)
        if backbone_impl not in BACKBONE_IMPLS:
            raise ValueError(
                f"backbone_impl must be module|folded|fused, got {backbone_impl!r}"
            )
        self.backbone_impl = backbone_impl
        self.dtype = compute_dtype(self.config)
        # Multi-device: the trunk's batch shards over every rank of the mesh
        # (parallel/sharded_extract), so backbone_batch must divide evenly.
        self.mesh = mesh
        if mesh is not None:
            if backbone_impl == "fused":
                raise ValueError(
                    "fused backbone_impl is single-device; the mesh path"
                    " shards the folded or module forward."
                )
            mesh.check_device(self.device)
            if self.backbone_batch % mesh.size != 0:
                raise ValueError(
                    f"backbone_batch={self.backbone_batch} must be divisible"
                    f" by the {mesh.size}-device mesh."
                )
            from mermaid_classifier_tpu_torch.parallel.sharded_extract import (
                make_sharded_feature_fn,
            )

            self._sharded = make_sharded_feature_fn(
                mesh, variables, self.config, backbone_impl=backbone_impl)
            self._forward = self._sharded.forward
        elif backbone_impl == "module":
            self._forward = _module_forward(variables, self.config, self.device)
        else:
            weights = fused_mbconv.to_device(
                fused_mbconv.fold_backbone(variables, self.config), self.device
            )
            run_fused = backbone_impl == "fused"
            cfg = self.config

            def forward(patches: torch.Tensor) -> torch.Tensor:
                return fused_mbconv.apply_folded(
                    weights, cfg, patches, fused=run_fused
                )

            self._forward = forward
        self._scale, self._bias = channel_scale_bias(
            self.config.mean_rgb, self.config.std_rgb
        )

    @property
    def feature_dim(self) -> int:
        return self.config.feature_dim

    # -- patch gathering ----------------------------------------------------

    def _prepare_image(self, image: np.ndarray) -> np.ndarray:
        """Centered zero pad (ps//2 each side) + bottom/right pad to the
        size bucket, host-side: the JAX extractor's padded frame, kept to
        hold the bucketing to it. No extraction path calls it: the crop
        folds the pad in and reads the raw image."""
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"image must be (H, W, 3), got {image.shape}")
        ps = self.config.patch_size
        half = ps // 2
        h, w, _ = image.shape
        hp = _round_up(h + 2 * half, self.image_bucket)
        wp = _round_up(w + 2 * half, self.image_bucket)
        out = np.zeros((hp, wp, 3), dtype=np.uint8)
        out[half : half + h, half : half + w] = image
        return out

    def _validate_rowcols(self, image: np.ndarray, rowcols) -> np.ndarray:
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"image must be (H, W, 3), got {image.shape}")
        rowcols = np.asarray(rowcols, dtype=np.int32)
        if rowcols.ndim != 2 or rowcols.shape[1] != 2:
            raise ValueError(f"rowcols must be (P, 2), got {rowcols.shape}")
        if rowcols.shape[0]:
            h, w, _ = image.shape
            if (rowcols < 0).any() or (rowcols[:, 0] >= h).any() or (
                rowcols[:, 1] >= w
            ).any():
                raise ValueError(
                    "rowcols contains points outside the image"
                    f" (image is {h}x{w})."
                )
        return rowcols

    @staticmethod
    def _pad_starts(rowcols: np.ndarray, multiple: int) -> np.ndarray:
        """Pad the point list up to ``multiple`` by duplicating point 0.
        With the centered ps//2 pad, a point's crop starts at its own
        (row, col) in the padded image."""
        n = rowcols.shape[0]
        starts = np.zeros((_round_up(n, multiple), 2), dtype=np.int32)
        starts[:n] = rowcols
        starts[n:] = rowcols[0]
        return starts

    def _upload(self, image: np.ndarray) -> torch.Tensor:
        """The raw (H, W, 3) uint8 image on the device.

        On the CPU: the image itself, copied only when it is not contiguous
        uint8. On CUDA: staged into a page-locked buffer (span
        ``extract.stage``, one per upload), then one non-blocking copy. A
        copy from pageable memory synchronizes the stream before it is
        queued, even with ``non_blocking=True``; this one waits for
        nothing, so the host queues this image while the card still runs
        the previous one (see the module docstring)."""
        with profiling.span("extract.upload"):
            if self.device.type != "cuda":
                return torch.from_numpy(
                    np.ascontiguousarray(image, dtype=np.uint8)).to(self.device)
            with profiling.span("extract.stage"):
                staged = stage(image, torch.empty(
                    image.shape, dtype=torch.uint8, pin_memory=True))
            return staged.to(self.device, non_blocking=True)

    def _crop(self, image: torch.Tensor, rowcols: np.ndarray) -> torch.Tensor:
        """Raw device image + validated, non-empty (P, 2) points -> the
        (P, ps, ps, 3) patches, cropped with the ps//2 pad folded in."""
        ps = self.config.patch_size
        starts = self._pad_starts(rowcols, self.point_bucket)
        patches = extract_patches(
            image, starts, ps, self._scale, self._bias, out_dtype=self.dtype,
            pad=ps // 2,
        )
        return patches[: rowcols.shape[0]]

    def extract_patches(self, image: np.ndarray, rowcols) -> torch.Tensor:
        """(H, W, 3) uint8 + (P, 2) points -> (P, ps, ps, 3) normalized
        patches on the device, in the trunk's compute dtype."""
        rowcols = self._validate_rowcols(image, rowcols)
        if rowcols.shape[0] == 0:
            ps = self.config.patch_size
            return torch.zeros((0, ps, ps, 3), dtype=self.dtype,
                               device=self.device)
        return self._crop(self._upload(image), rowcols)

    # -- backbone -----------------------------------------------------------

    def features_for_patches_device(self, patches: torch.Tensor) -> torch.Tensor:
        """(P, ps, ps, 3) -> (P, D) float32 on the device, in chunks of
        ``backbone_batch`` patches."""
        n = patches.shape[0]
        if n == 0:
            return torch.zeros((0, self.feature_dim), device=self.device)
        bb = self.backbone_batch
        if self.mesh is not None:
            # Zero patches up to whole chunks, each chunk sharded.
            pad = -n % bb
            if pad:
                patches = torch.cat(
                    [patches, patches.new_zeros((pad, *patches.shape[1:]))])
            outs = [self._sharded(patches[i: i + bb]) for i in range(0, n + pad, bb)]
            return torch.cat(outs)[:n]
        with torch.inference_mode():
            outs = [self._forward(patches[i : i + bb]) for i in range(0, n, bb)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def features_for_patches(self, patches: torch.Tensor) -> np.ndarray:
        return self.features_for_patches_device(patches).cpu().numpy()

    def extract_features_device(self, image: np.ndarray, rowcols) -> torch.Tensor:
        """Per-image features as a (P, D) device tensor (no host readback)."""
        if self.mesh is not None:
            return self._extract_sharded(image, rowcols)
        return self.features_for_patches_device(
            self.extract_patches(image, rowcols)
        )

    def _extract_sharded(self, image: np.ndarray, rowcols) -> torch.Tensor:
        """The mesh path of ``extract_features_device``: this rank's share
        of every chunk of points, cropped in one launch, through its trunk
        replica, then all-gathered back into point order."""
        rowcols = self._validate_rowcols(image, rowcols)
        n = rowcols.shape[0]
        if n == 0:
            return torch.zeros((0, self.feature_dim), device=self.device)
        mesh, bb, ps = self.mesh, self.backbone_batch, self.config.patch_size
        share = bb // mesh.size
        starts = self._pad_starts(rowcols, bb)
        n_chunks = len(starts) // bb
        mine = starts.reshape(n_chunks, mesh.size, share, 2)[:, mesh.rank]
        patches = extract_patches(
            self._upload(image), mine.reshape(-1, 2), ps, self._scale,
            self._bias, out_dtype=self.dtype, pad=ps // 2,
        )
        with torch.inference_mode():
            local = torch.cat([self._forward(patches[c * share:(c + 1) * share])
                               for c in range(n_chunks)])
            feats = self._sharded.gather(local)
        # Rank-major (rank, chunk, share) back to point order.
        feats = feats.view(mesh.size, n_chunks, share, -1).transpose(0, 1)
        return feats.reshape(n_chunks * bb, -1)[:n]

    def extract_features_async(self, image: np.ndarray, rowcols) -> FeatureReadback:
        """Dispatch one image and queue its features' readback without
        waiting for it (see the module docstring). On the CPU the
        hand-off is a plain copy. Spans: ``extract.dispatch`` over the
        call, ``extract.upload`` (``_upload``, with its ``extract.stage``
        on CUDA) within it; the rest of the dispatch is the enqueue."""
        with profiling.span("extract.dispatch"):
            features = self.extract_features_device(image, rowcols)
            if features.device.type != "cuda":
                return FeatureReadback(features.clone())
            host = torch.empty(features.shape, dtype=features.dtype, pin_memory=True)
            host.copy_(features, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(features.device))
            return FeatureReadback(host, event)

    def extract_features(self, image: np.ndarray, rowcols) -> np.ndarray:
        """The per-image entry point: decoded image + points -> (P, D)
        float32 features on the host."""
        return self.extract_features_device(image, rowcols).cpu().numpy()

    def extract_features_many(
        self, items: list[tuple[np.ndarray, np.ndarray]]
    ) -> list[np.ndarray]:
        """Pack every image's patches into one backbone pass, split per
        image (the trunk has no cross-patch coupling, so the numbers are
        those of per-image extraction)."""
        if not items:
            return []
        batches = [self.extract_patches(image, rc) for image, rc in items]
        counts = [b.shape[0] for b in batches]
        features = self.features_for_patches(torch.cat(batches))
        out = []
        offset = 0
        for count in counts:
            out.append(features[offset : offset + count])
            offset += count
        return out

    # -- numerics self-check ------------------------------------------------

    def verify_device_numerics(
        self, n_patches: int = 8, min_cosine: float = 0.999, seed: int = 0
    ) -> float:
        """Run seeded random patches through the backbone as configured
        (device, impl, compute dtype) and through the f32 ``nn.Module``
        forward on the CPU; raise DeviceNumericsError below ``min_cosine``.
        Returns the worst per-patch cosine."""
        ps = self.config.patch_size
        rng = np.random.default_rng(seed)
        patches = rng.random((n_patches, ps, ps, 3)).astype(np.float32)
        with torch.inference_mode():
            got = self._forward(
                torch.from_numpy(patches).to(self.device)
            ).float().cpu().numpy()
            reference = _module_forward(
                self.variables, replace(self.config, compute_dtype="float32"),
                torch.device("cpu"),
            )
            want = reference(torch.from_numpy(patches)).numpy()
        num = np.sum(got.astype(np.float64) * want, axis=1)
        denom = np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1)
        worst = float(np.min(num / np.maximum(denom, 1e-12)))
        if not worst >= min_cosine:
            raise DeviceNumericsError(
                f"device backbone features diverge from the f32 CPU"
                f" reference: min cosine {worst:.6f} < {min_cosine}."
            )
        return worst


def build_extractor(
    weights: Any | None = None,
    config: EfficientNetConfig | None = None,
    seed: int = 0,
    *,
    device,
    **kwargs: Any,
) -> FeatureExtractor:
    """An extractor from a flax-layout weights bundle (numpy) or, when None,
    the seeded weights of ``init_backbone_params(seed)``."""
    config = config or EfficientNetConfig()
    if weights is None:
        weights = init_backbone_params(seed, config)
    return FeatureExtractor(weights, config, device=device, **kwargs)
