"""Production-geometry preflight: the real sharded programs at REAL shapes,
with no data and no execution.

Port of ``mermaid_classifier_tpu/parallel/preflight.py``. The JAX module
AOT-lowers and compiles each program on the mesh. PyTorch compiles nothing
ahead of time, so here each leg is built by the same factory the
production path calls and run once on the ``meta`` device at the real
shapes: every operation checks its shapes and dtypes and allocates nothing,
and no kernel launches (the collectives only shape their outputs,
``Mesh.on_meta``). What the pass proves is that the code runs at these
shapes on this mesh's rank layout; ``seconds`` is the wall time of that
build + meta pass (the counterpart of JAX's ``compile_seconds``), and
``argument_mb`` / ``output_mb`` come from the shapes this rank is given and
returns.

Legs (the three the C2 + extraction drives run):

- data-parallel B0 224^2 folded-backbone extraction at ``extract_batch``
  (``sharded_extract.make_sharded_feature_fn``);
- one step of the row-sharded resident epoch at the realized C2 subsample
  scale, int8 (or f32/bf16) (``MLPClassifier``'s mesh step);
- the shipped head over the full val span, batch sharded
  (``sharded_serve.make_sharded_head_fn``).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from mermaid_classifier_tpu_torch.parallel.mesh import Mesh

#: The C2 production geometry: realized balanced subsample 449,099 rows x
#: 4096-dim features, 80 classes, the (500, 300, 100) production head, a
#: 44,910-row val span for the eval-the-artifact head pass, B0 extraction at
#: backbone_batch 128.
C2_GEOMETRY = {
    "n_rows": 449_099,
    "dim": 4096,
    "n_classes": 80,
    "hidden": (500, 300, 100),
    "resident_dtype": "int8",
    "val_rows": 44_910,
    "extract_batch": 128,
}

def _mb(*tensors) -> float:
    return round(sum(t.numel() * t.element_size() for t in tensors) / 1e6, 1)


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def production_geometry_report(mesh: Mesh, geometry: dict | None = None) -> dict:
    """Run the three production programs on the ``meta`` device at
    ``geometry`` (default: the C2 production geometry) with ``mesh``'s rank
    layout. Returns a report dict; raises on a geometry the mesh cannot
    shard or a shape error in any leg."""
    geo = dict(C2_GEOMETRY)
    geo.update(geometry or {})
    n_devices = mesh.size
    meta = mesh.on_meta()
    report: dict[str, Any] = {"devices": int(n_devices), "geometry": geo}

    # --- leg 1: dp B0 extraction at (extract_batch, 224, 224, 3) -------------
    from mermaid_classifier_tpu_torch.models.efficientnet import (
        EfficientNetConfig,
        init_backbone_params,
    )
    from mermaid_classifier_tpu_torch.parallel.sharded_extract import (
        make_sharded_feature_fn,
    )

    config = EfficientNetConfig()
    batch = int(geo["extract_batch"])
    if batch % n_devices:
        raise ValueError(
            f"extract_batch {batch} must divide the {n_devices}-device mesh"
        )
    t0 = time.perf_counter()
    extract = make_sharded_feature_fn(meta, init_backbone_params(0, config), config)
    ps = config.patch_size
    local = torch.empty((batch // n_devices, ps, ps, 3), device="meta")
    with torch.inference_mode():
        feats = extract.gather(extract.forward(local))
    if tuple(feats.shape) != (batch, config.feature_dim):
        raise RuntimeError(f"extraction gave {tuple(feats.shape)}")
    report["extract_b0"] = {
        "batch": batch,
        "patch": ps,
        "seconds": round(time.perf_counter() - t0, 1),
        "argument_mb": _mb(local, *_tensors(extract.weights)),
        "output_mb": _mb(feats),
    }

    # --- leg 2: the resident epoch's step at C2 scale -------------------------
    from mermaid_classifier_tpu_torch.train.mlp_classifier import (
        _STORAGE_DTYPES,
        MLPClassifier,
        _StepRunner,
    )

    t0 = time.perf_counter()
    n_rows = int(geo["n_rows"])
    dim = int(geo["dim"])
    n_classes = int(geo["n_classes"])
    dtype = str(geo["resident_dtype"])
    if dtype not in _STORAGE_DTYPES:
        raise ValueError(f"resident_dtype must be one of {tuple(_STORAGE_DTYPES)}")
    # The mesh resident path's padding rules (MLPClassifier._local_block:
    # rows pad to the rank-count multiple; _run_steps: the sklearn-auto
    # minibatch pads to the rank-count multiple).
    rows_padded = n_rows + (-n_rows % n_devices)
    batch_size = min(200, n_rows)
    batch_padded = batch_size + (-batch_size % n_devices)
    n_batches = -(-n_rows // batch_size)
    clf = MLPClassifier(tuple(geo["hidden"]), random_state=0, mesh=meta,
                        device="meta")
    clf._first_fit(dim, None, np.arange(n_classes))
    block = rows_padded // n_devices
    lo = meta.rank * block
    clf._resident_X = torch.empty((block, dim), dtype=_STORAGE_DTYPES[dtype],
                                    device="meta")
    clf._resident_scale = (torch.empty(block, device="meta") if dtype == "int8"
                           else None)
    clf._resident_shard = (lo, lo + block)
    runner = _StepRunner(clf.device, clf._resident_X, clf._resident_scale,
                         clf._class_weights_on_device(), batch_padded, 1,
                         ("owner", lo, lo + block))
    runner.step(clf)
    state = clf._state_tensors()
    report["resident_epoch"] = {
        "rows": n_rows,
        "rows_padded": rows_padded,
        "dim": dim,
        "dtype": dtype,
        "n_batches": n_batches,
        "batch_rows": batch_padded,
        "buffer_gb_per_device": round(
            block * dim * clf._resident_X.element_size() / 1e9, 2
        ),
        "seconds": round(time.perf_counter() - t0, 1),
        "argument_mb": _mb(*state, *_tensors([clf._resident_X,
                                              clf._resident_scale]),
                           runner.batches),
        "output_mb": _mb(*state, runner.losses),
    }

    # --- leg 3: the shipped head over the full val span, batch-sharded -------
    from mermaid_classifier_tpu_torch.inference.head import HeadParams
    from mermaid_classifier_tpu_torch.parallel.sharded_serve import (
        make_sharded_head_fn,
    )

    t0 = time.perf_counter()
    val_rows = int(geo["val_rows"])
    val_padded = val_rows + (-val_rows % n_devices)
    sizes = (dim, *geo["hidden"], n_classes)
    head = HeadParams(
        [np.zeros((i, o), np.float32) for i, o in zip(sizes[:-1], sizes[1:])],
        [np.zeros(o, np.float32) for o in sizes[1:]],
        np.zeros(n_classes, np.float32), np.zeros(n_classes, np.float32),
    )
    serve = make_sharded_head_fn(meta, head)
    local = torch.empty((val_padded // n_devices, dim), device="meta")
    proba = serve.device_call(local)
    if tuple(proba.shape) != (val_padded, n_classes):
        raise RuntimeError(f"the head gave {tuple(proba.shape)}")
    report["serve_head"] = {
        "rows": val_rows,
        "rows_padded": val_padded,
        "n_classes": n_classes,
        "seconds": round(time.perf_counter() - t0, 1),
        "argument_mb": _mb(local, *_tensors(serve.tensors)),
        "output_mb": _mb(proba),
    }
    return report
