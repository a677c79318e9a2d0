"""One gloo rank of the port's multi-process CPU tests (it holds no test
of its own).

``tests/test_torch_parallel.py`` (and ``tests/test_torch_preflight.py``)
start ``world`` copies of this script, one per rank, with the variables
``torchrun`` would set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``). Each rank reads ``inputs.pkl`` from the
run directory, joins the process group from the environment, builds the
default mesh over every rank on the CPU, runs the named checks in order and
pickles each check's arrays (or its traceback) into ``rank<r>.pkl``. It
imports the port only, never jax.

    python tests/test_torch_parallel_worker.py <run dir> <check> [<check> ...]
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

CHECKS = {}


def check(fn):
    CHECKS[fn.__name__] = fn
    return fn


def _tiny(inp):
    from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig

    return EfficientNetConfig.from_dict(inp["tiny"])


def _tiny_variables(inp):
    from mermaid_classifier_tpu_torch.models.efficientnet import init_backbone_params

    return init_backbone_params(0, _tiny(inp))


@check
def mesh_layout(mesh, inp):
    return {"shape": np.array(mesh.shape),
            "position": np.array([mesh.rank, mesh.data_rank, mesh.model_rank])}


@check
def extract_folded(mesh, inp):
    from mermaid_classifier_tpu_torch.ops import fused_mbconv
    from mermaid_classifier_tpu_torch.parallel.sharded_extract import (
        make_sharded_feature_fn,
    )

    cfg, variables = _tiny(inp), _tiny_variables(inp)
    patches = torch.from_numpy(inp["patches"])
    sharded = make_sharded_feature_fn(mesh, variables, cfg)(patches)
    weights = fused_mbconv.to_device(fused_mbconv.fold_backbone(variables, cfg), "cpu")
    with torch.inference_mode():
        single = fused_mbconv.apply_folded(weights, cfg, patches)
    return {"sharded": sharded.numpy(), "single": single.numpy()}


@check
def extract_module(mesh, inp):
    from mermaid_classifier_tpu_torch.parallel.sharded_extract import (
        make_sharded_feature_fn,
    )

    run = make_sharded_feature_fn(mesh, _tiny_variables(inp), _tiny(inp),
                                  backbone_impl="module")
    return {"sharded": run(torch.from_numpy(inp["patches"])).numpy()}


@check
def extractor_mesh(mesh, inp):
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor
    from mermaid_classifier_tpu_torch.ops import patch_crop

    opts = dict(inp["extractor_opts"], backbone_impl="folded", device="cpu")
    variables, cfg = _tiny_variables(inp), _tiny(inp)
    meshed = build_extractor(variables, cfg, mesh=mesh, **opts)
    single = build_extractor(variables, cfg, **opts)
    items = inp["images"]
    return {
        "mesh": [meshed.extract_features(img, pts) for img, pts in items],
        "many": meshed.extract_features_many(items),
        "single": [single.extract_features(img, pts) for img, pts in items],
        # On the CPU the wrapper runs the plain crop: no launch to count.
        "crop_launches": np.array(patch_crop.launches),
    }


@check
def sharded_head(mesh, inp):
    from mermaid_classifier_tpu_torch.inference.head import HeadParams
    from mermaid_classifier_tpu_torch.parallel.sharded_serve import (
        make_sharded_head_fn,
    )

    return {"proba": make_sharded_head_fn(mesh, HeadParams(*inp["head"]))(
        inp["head_features"])}


@check
def sharded_predictor(mesh, inp):
    from mermaid_classifier_tpu_torch.inference.loader import load_predictor
    from mermaid_classifier_tpu_torch.parallel.sharded_serve import (
        load_sharded_predictor,
    )

    feats = inp["artifact_features"]
    meshed = load_sharded_predictor(inp["artifact"], mesh)
    return {"mesh": meshed.predict_proba(feats),
            "single": load_predictor(inp["artifact"], device="cpu").predict_proba(feats),
            "classes": np.array(meshed.classes)}


def _trainer_run(mesh, inp, layers):
    from mermaid_classifier_tpu_torch.parallel.sharded_train import (
        ShardedHeadTrainer,
    )

    trainer = ShardedHeadTrainer(mesh, layers, learning_rate=1e-3, alpha=0.01)
    params = trainer.shard_params(inp["trainer_init"][layers])
    opt_state = trainer.init_opt_state(params)
    losses = []
    for x, y, w in inp["trainer_batches"][layers]:
        params, opt_state, loss = trainer.train_step(
            params, opt_state, *trainer.place_batch(x, y, w), 14.0)
        losses.append(loss)
    full = trainer.unshard_params(params)
    x_eval = inp["trainer_batches"][layers][0][0][:8]
    return {"losses": np.array(losses), "W": full["W"], "b": full["b"],
            "proba": trainer.predict_proba(params, x_eval).numpy()}


@check
def trainer_step(mesh, inp):
    return _trainer_run(mesh, inp, (12, 8, 6, 4))


@check
def trainer_step_uneven(mesh, inp):
    return _trainer_run(mesh, inp, (12, 7, 6, 5))


def _mlp(mesh, **kw):
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

    return MLPClassifier(init="sklearn", mesh=mesh, device="cpu", **kw)


@check
def stream_fit(mesh, inp):
    X, y, classes = inp["stream"]
    clf = _mlp(mesh, hidden_layer_sizes=(8,), batch_size=15, random_state=3)
    for _ in range(3):
        clf.partial_fit(X, y, classes=classes)
    return {"loss_curve": np.array(clf.loss_curve_), "coefs": clf.coefs_,
            "proba": clf.predict_proba(X)}


def _resident(mesh, inp, dtype):
    X, y, classes, orders = inp["resident"]
    clf = _mlp(mesh, hidden_layer_sizes=(12,), random_state=2)
    clf.set_resident_features(X, dtype=dtype)
    for order in orders:
        for s in range(0, len(order), 128):
            idx = order[s:s + 128]
            clf.partial_fit_resident(idx, y[idx], classes=classes)
    probe = np.arange(0, len(X), 7)
    return {"loss_curve": np.array(clf.loss_curve_), "coefs": clf.coefs_,
            "proba": clf.predict_proba_resident(probe),
            "eval_counts": clf.eval_counts_resident(
                probe, np.searchsorted(clf.classes_, y[probe])),
            "buffer_rows": np.array(clf._resident_X.shape[0])}


@check
def resident_f32(mesh, inp):
    return _resident(mesh, inp, "float32")


@check
def resident_bf16(mesh, inp):
    return _resident(mesh, inp, "bfloat16")


@check
def resident_int8(mesh, inp):
    return _resident(mesh, inp, "int8")


@check
def trainer_mesh(mesh, inp):
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier
    from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer

    class MeshTrainer(MermaidTrainer):
        def _make_classifier(self, class_weight):
            return MLPClassifier(hidden_layer_sizes=(16,), learning_rate_init=1e-2,
                                 class_weight=class_weight, random_state=0,
                                 init="sklearn", mesh=self.mesh, device="cpu")

    # Streamed at 2 ranks, resident at 4, as the test holds them.
    resident = mesh.size > 2
    trainer = MeshTrainer(batch_size=64, device_resident=resident,
                          device="cpu", mesh=mesh)
    _, _, msg = trainer(inp["task_labels"], nbr_epochs=3, pc_models=[])
    return {f"ref_accs_{resident}": np.array(msg.ref_accs),
            f"acc_{resident}": np.array(msg.acc)}


@check
def runner_mesh(mesh, inp):
    """The recipe runner with ``train_mesh_devices`` = the world size, every
    rank on the same feature cache and tracking root, as ``torchrun`` starts
    them at the defaults. Rank 0 returns what it registered, the other
    ranks that they registered nothing."""
    from mermaid_classifier_tpu_torch.config.settings import override_settings
    from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore
    from mermaid_classifier_tpu_torch.inference import load_predictor
    from mermaid_classifier_tpu_torch.tracking.local_tracker import LocalTracker
    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier
    from mermaid_classifier_tpu_torch.train.runner import TrackingTrainingRunner
    from mermaid_classifier_tpu_torch.train.trainer import MermaidTrainer

    class SmallTrainer(MermaidTrainer):
        def _make_classifier(self, class_weight):
            return MLPClassifier(hidden_layer_sizes=(16,), learning_rate_init=1e-2,
                                 class_weight=class_weight, random_state=0,
                                 init="sklearn", mesh=self.mesh, device=self.device)

    class SmallRunner(TrackingTrainingRunner):
        def _make_trainer(self, batch_size, class_weight):
            trainer = super()._make_trainer(batch_size, class_weight)
            trainer.__class__ = SmallTrainer
            return trainer

    shared = Path(inp["run_root"])
    with override_settings(feature_cache_dir=str(shared / "cache"),
                           train_mesh_devices=mesh.size, **inp["settings"]):
        runner = SmallRunner(**inp["options"], tracker=LocalTracker(shared / "track"),
                             store=LocalFSObjectStore(inp["store_root"]),
                             device="cpu", enforce_torch_pin=False)
        msg, registered = runner.run(run_name="run")
    out = {"ref_accs": np.array(msg.ref_accs), "acc": np.array(msg.acc),
           "registered": np.array(registered is not None)}
    if registered is not None:
        out["proba"] = load_predictor(registered, device="cpu").predict_proba(
            inp["probe"])
    return out


def _enter(context) -> None:
    with context:
        pass


@check
def raises(mesh, inp):
    """The messages of the calls that must raise."""
    from mermaid_classifier_tpu_torch.inference.head import HeadParams
    from mermaid_classifier_tpu_torch.models.extractor import build_extractor
    from mermaid_classifier_tpu_torch.parallel.mesh import cli_mesh
    from mermaid_classifier_tpu_torch.parallel.sharded_extract import (
        make_sharded_feature_fn,
    )
    from mermaid_classifier_tpu_torch.parallel.sharded_serve import (
        make_sharded_head_fn,
    )

    cfg, variables = _tiny(inp), _tiny_variables(inp)
    calls = {
        "indivisible_extract": lambda: make_sharded_feature_fn(
            mesh, variables, cfg)(torch.zeros((mesh.size + 1, 32, 32, 3))),
        "fused_with_mesh": lambda: build_extractor(
            variables, cfg, device="cpu", backbone_impl="fused", mesh=mesh),
        "indivisible_backbone_batch": lambda: build_extractor(
            variables, cfg, device="cpu", backbone_impl="folded",
            backbone_batch=mesh.size + 1, mesh=mesh),
        "head_indivisible": lambda: make_sharded_head_fn(
            mesh, HeadParams(*inp["head"]))(np.zeros((mesh.size + 1, 12), np.float32)),
        "head_width": lambda: make_sharded_head_fn(
            mesh, HeadParams(*inp["head"]))(np.zeros((mesh.size, 5), np.float32)),
        "world_size_mismatch": lambda: _enter(cli_mesh(
            mesh.size + 1, device="cpu",
            command="mermaid_classifier_tpu_torch.scripts.predict_features")),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
        except (ValueError, SystemExit) as exc:
            out[name] = np.array(f"{type(exc).__name__}: {exc}")
        else:
            out[name] = np.array("no error")
    return out


@check
def predict_cli(mesh, inp):
    from mermaid_classifier_tpu_torch.scripts import predict_features

    rc = predict_features.main([
        "--classifier", str(inp["artifact"]), "--output", str(inp["cli_csv"]),
        "--mesh-devices", str(mesh.size), "--device", "cpu", "--batch-size", "5",
        *[str(p) for p in inp["feature_files"]]])
    return {"rc": np.array(rc)}


@check
def bucket_cli(mesh, inp):
    """``build_feature_bucket --mesh-devices`` over the store at
    ``inp["bucket_store"]``: every rank extracts, rank 0 writes."""
    from mermaid_classifier_tpu_torch.config.settings import override_settings
    from mermaid_classifier_tpu_torch.scripts import build_feature_bucket

    with override_settings(object_store_root=str(inp["bucket_store"])):
        rc = build_feature_bucket.main(
            [*inp["bucket_argv"], "--mesh-devices", str(mesh.size)])
    return {"rc": np.array(rc)}


@check
def preflight(mesh, inp):
    from mermaid_classifier_tpu_torch.parallel.preflight import (
        production_geometry_report,
    )

    out = {}
    for name, geometry in inp["preflight"].items():
        try:
            out[name] = production_geometry_report(mesh, geometry)
        except ValueError as exc:
            out[name] = f"ValueError: {exc}"
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(world: int, run_dir: Path, inputs: dict, checks: list[str]):
    """Write ``inputs`` and start ``world`` ranks running ``checks``; each
    rank's output goes to ``rank<r>.log`` in ``run_dir``."""
    import subprocess

    with open(run_dir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        with open(run_dir / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(run_dir),
                 *checks], env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def collect(procs, run_dir: Path, deadline: float) -> list[dict]:
    """Wait for the ranks until ``deadline`` (``time.monotonic``), kill
    every rank left at it, and return each rank's results; raise with the
    logs when a rank timed out or failed."""
    import subprocess
    import time

    failed = []
    for rank, proc in enumerate(procs):
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            failed.append(f"rank {rank}: timed out")
        else:
            if proc.returncode:
                failed.append(f"rank {rank}: exit {proc.returncode}")
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if failed:
        logs = "".join((run_dir / f"rank{r}.log").read_text()[-3000:]
                       for r in range(len(procs)))
        raise RuntimeError(f"{failed}\n{logs}")
    out = []
    for rank in range(len(procs)):
        with open(run_dir / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def main(argv: list[str]) -> int:
    from mermaid_classifier_tpu_torch.parallel.mesh import make_mesh

    run_dir, names = Path(argv[0]), argv[1:]
    torch.set_num_threads(1)
    with open(run_dir / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh(device="cpu")
    results = {}
    try:
        for name in names:
            try:
                results[name] = CHECKS[name](mesh, inp)
            except Exception:  # noqa: BLE001 - reported to the test
                results[name] = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(run_dir / f"rank{os.environ['RANK']}.pkl", "wb") as f:
        pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
