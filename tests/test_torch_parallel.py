"""The port's parallel layer against the JAX package's, on the CPU.

The port side runs in W = 2 and W = 4 gloo ranks (``tests/
test_torch_parallel_worker.py``, started once per module with one shared
deadline, every rank given the same seeded numpy inputs); the JAX side runs
in this process on ``make_mesh(W)`` over conftest's 8 virtual CPU devices.
Every rank must return the same global result; rank 0's is held to JAX at
JAX's own tolerances (``tests/parallel/test_sharded.py``,
``tests/train/test_mlp_classifier.py``, ``tests/train/test_trainer.py``):

- mesh factorizations and rank layout equal;
- sharded ``folded`` features rtol 1e-5 / atol 1e-6 against the JAX sharded
  ones and the port's single-device fold; sharded ``module`` against the
  single JAX ``flax`` forward rtol 1e-4 / atol 1e-5; the mesh extractor
  (one crop per rank) against the JAX mesh extractor rel 1e-4 (the port
  extractor tests' bound) and the single-device port rtol 1e-5;
- the sharded head rtol 1e-6 / atol 1e-7 and rows summing to 1 within 1e-5;
  the sharded predictor and the ``--mesh-devices`` CLI scores atol 1e-6;
- three ``ShardedHeadTrainer`` steps from the same numpy weights: losses
  within 1e-5, weights rtol 1e-5 / atol 1e-6; at widths the model axis does
  not divide (which the JAX trainer's placement refuses and the port pads)
  against the JAX single-device step;
- the streamed mesh ``partial_fit``: loss curve rel 2e-5, weights rtol 2e-5
  / atol 1e-6; resident f32 / bf16 / int8 over n = 300 rows (no rank count
  divides it): losses abs 1e-6, weights rtol 1e-5 / atol 1e-6;
- the trainer on a mesh: ``ref_accs`` and accuracy abs 1e-6;
- indivisible batches, ``fused`` with a mesh and a ``WORLD_SIZE`` mismatch
  raise.
"""

import csv
import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from mermaid_classifier_tpu.inference import export_artifact
from mermaid_classifier_tpu.inference.head import HeadParams as JHeadParams
from mermaid_classifier_tpu.inference.head import head_apply as jhead_apply
from mermaid_classifier_tpu.data import feature_bucket as jfb
from mermaid_classifier_tpu.data.features_io import (
    read_feature_file,
    write_feature_file,
)
from mermaid_classifier_tpu.data.store import LocalFSObjectStore as JStore
from mermaid_classifier_tpu.models import extractor as jext
from mermaid_classifier_tpu.models.efficientnet import (
    EfficientNetBackbone,
    init_backbone_params,
)
from mermaid_classifier_tpu.parallel.mesh import default_mesh_spec, make_mesh
from mermaid_classifier_tpu.parallel.sharded_extract import make_sharded_feature_fn
from mermaid_classifier_tpu.parallel.sharded_serve import load_sharded_predictor
from mermaid_classifier_tpu.parallel.sharded_train import ShardedHeadTrainer
from mermaid_classifier_tpu.serve import batch_predict as jbp
from mermaid_classifier_tpu.train.calibration import CalibratedClassifier
from mermaid_classifier_tpu.train.mlp_classifier import MLPClassifier as JMLP
from mermaid_classifier_tpu.train.trainer import MermaidTrainer as JTrainer
from mermaid_classifier_tpu_torch.config import settings as tset
from mermaid_classifier_tpu_torch.data.store import LocalFSObjectStore as TStore
from mermaid_classifier_tpu_torch.models.convert import save_backbone_npz
from mermaid_classifier_tpu_torch.parallel import mesh as tmesh
from mermaid_classifier_tpu_torch.scripts import build_feature_bucket
from tests.models.test_efficientnet import TINY
from tests.parallel import test_sharded as jsharded
from tests.test_torch_efficientnet import port_config
from tests.test_torch_feature_bucket import (
    DST,
    SRC,
    log_records,
    populate,
)
from tests.test_torch_parallel_worker import collect, start_ranks
from tests.torch_training_data import synthetic_tasks

WORLDS = (2, 4)
TRAINER_LAYERS = ((12, 8, 6, 4), (12, 7, 6, 5))
EXTRACTOR_OPTS = dict(backbone_batch=8, point_bucket=4, image_bucket=64)
CHECKS = ["mesh_layout", "extract_folded", "extract_module", "extractor_mesh",
          "sharded_head", "sharded_predictor", "trainer_step",
          "trainer_step_uneven", "stream_fit", "resident_f32", "resident_bf16",
          "resident_int8", "trainer_mesh", "raises", "predict_cli", "bucket_cli"]
#: One deadline for both worlds' ranks: a hung collective fails the tests
#: that read them instead of running the suite into its time limit.
DEADLINE_SECONDS = 150


def _head_params(n_classes=5, dim=12, seed=3):
    rng = np.random.default_rng(seed)
    sizes = (dim, 8, n_classes)
    return (
        [rng.standard_normal((i, o)).astype(np.float32) * 0.5
         for i, o in zip(sizes[:-1], sizes[1:])],
        [rng.standard_normal(o).astype(np.float32) * 0.1 for o in sizes[1:]],
        rng.standard_normal(n_classes).astype(np.float32) - 1.0,
        rng.standard_normal(n_classes).astype(np.float32) * 0.2,
    )


def _images():
    out = []
    for seed, (h, w, n) in enumerate(((70, 90, 11), (40, 50, 16), (33, 65, 3))):
        rng = np.random.default_rng(seed)
        image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        pts = np.stack([rng.integers(0, h, n), rng.integers(0, w, n)], 1)
        pts[0] = [h - 1, w - 1]
        out.append((image, pts.astype(np.int32)))
    return out


def _trainer_inputs():
    inits, batches = {}, {}
    for layers in TRAINER_LAYERS:
        rng = np.random.default_rng(sum(layers))
        inits[layers] = {
            "W": [rng.uniform(-0.5, 0.5, (i, o)).astype(np.float32)
                  for i, o in zip(layers[:-1], layers[1:])],
            "b": [rng.uniform(-0.1, 0.1, o).astype(np.float32) for o in layers[1:]],
        }
        steps = []
        for _ in range(3):
            x = rng.standard_normal((16, layers[0])).astype(np.float32)
            y = rng.integers(0, layers[-1], size=16).astype(np.int32)
            w = np.ones(16, np.float32)
            w[-2:] = 0.0  # padding rows
            steps.append((x, y, w))
        batches[layers] = steps
    return inits, batches


def _resident_inputs():
    rng = np.random.default_rng(5)
    n, dim, k = 300, 16, 3
    centers = rng.normal(0, 3, size=(k, dim)).astype(np.float32)
    y_idx = rng.integers(0, k, n)
    X = (centers[y_idx] + rng.normal(0, 0.5, (n, dim))).astype(np.float32)
    y = np.asarray([f"c{i}" for i in y_idx])
    rng2 = np.random.default_rng(1)
    orders = [rng2.permutation(n) for _ in range(2)]
    return X, y, sorted(set(y.tolist())), orders


def _stream_inputs():
    rng = np.random.default_rng(0)
    n, d, k = 64, 12, 4
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = np.asarray([f"c{i}" for i in rng.integers(0, k, n)])
    return X, y, sorted(set(y.tolist()) | {f"c{i}" for i in range(k)})


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_inputs")
    # The exported artifact and feature files of the serve checks.
    rng = np.random.default_rng(0)
    dim, k = 16, 3
    centers = rng.normal(0, 3, size=(k, dim))
    y_idx = rng.integers(0, k, 200)
    X = (rng.normal(0, 1, size=(200, dim)) + centers[y_idx]).astype(np.float32)
    labels = np.array([f"ba-{i}::" for i in range(k)])
    clf = JMLP(hidden_layer_sizes=(8,), random_state=0)
    for _ in range(5):
        clf.partial_fit(X, labels[y_idx], classes=list(labels))
    model = CalibratedClassifier.fit_from_scores(
        clf, clf.predict_proba(X), labels[y_idx])
    export_artifact(model, root / "artifact", X[:16])
    files = []
    for i, n_points in enumerate((5, 1, 7)):
        rowcols = rng.integers(0, 100, size=(n_points, 2)).astype(np.int64)
        p = root / f"i{i}.features.npz"
        write_feature_file(p, rowcols,
                           rng.normal(0, 2, size=(n_points, dim)).astype(np.float32))
        files.append(p)
    _, task_labels = synthetic_tasks(root / "tasks", n_images=40, pts_per_image=10,
                                     n_classes=3, dim=8, seed=0)
    save_backbone_npz(str(root / "weights.npz"), init_backbone_params(0, TINY),
                      port_config(TINY))
    inits, batches = _trainer_inputs()
    return {
        "tiny": TINY.to_dict(),
        "patches": np.random.default_rng(1).standard_normal(
            (16, 32, 32, 3)).astype(np.float32),
        "extractor_opts": EXTRACTOR_OPTS,
        "images": _images(),
        "head": _head_params(),
        "head_features": np.random.default_rng(0).standard_normal(
            (32, 12)).astype(np.float32),
        "artifact": root / "artifact",
        "artifact_features": np.random.default_rng(4).normal(
            0, 2, size=(13, dim)).astype(np.float32),
        "feature_files": files,
        "trainer_init": inits,
        "trainer_batches": batches,
        "stream": _stream_inputs(),
        "resident": _resident_inputs(),
        "task_labels": task_labels,
        "weights": root / "weights.npz",
    }


def _bucket_argv(weights, logs):
    return ["--source-ids", "1,2,7", "--source-bucket", SRC, "--target-bucket", DST,
            "--backbone-weights", str(weights), "--device", "cpu",
            "--backbone-batch", "8", "--progress-log", str(logs / "progress.jsonl"),
            "--error-log", str(logs / "errors.csv")]


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """Each world's per-rank results, both worlds run at once."""
    started = {}
    for world in WORLDS:
        run_dir = tmp_path_factory.mktemp(f"ranks{world}")
        populate(TStore(run_dir / "store"), corrupt=True)
        inp = dict(inputs, cli_csv=run_dir / "predictions.csv",
                   bucket_store=run_dir / "store",
                   bucket_argv=_bucket_argv(inputs["weights"], run_dir))
        started[world] = (run_dir, start_ranks(world, run_dir, inp, CHECKS))
    deadline = time.monotonic() + DEADLINE_SECONDS
    out = {}
    for world, (run_dir, procs) in started.items():
        out[world] = (run_dir, collect(procs, run_dir, deadline))
    return out


def _result(port, world, name):
    """Rank 0's result of one check, after the check that no rank raised."""
    _, ranks = port[world]
    for rank, res in enumerate(ranks):
        assert "error" not in res[name], f"rank {rank}: {res[name]['error']}"
    return ranks[0][name]


def _same_on_every_rank(port, world, name, keys):
    _, ranks = port[world]
    for res in ranks[1:]:
        for key in keys:
            a, b = ranks[0][name][key], res[name][key]
            for x, y in zip(a if isinstance(a, list) else [a],
                            b if isinstance(b, list) else [b]):
                np.testing.assert_array_equal(x, y)


def test_mesh_factorizations_match_jax():
    for n in range(1, 17):
        for mp in (None, 1, 2, 4):
            try:
                want = default_mesh_spec(n, mp)
            except ValueError:
                with pytest.raises(ValueError):
                    tmesh.default_mesh_spec(n, mp)
                continue
            got = tmesh.default_mesh_spec(n, mp)
            assert (got.data, got.model) == (want.data, want.model)


def test_cuda_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tmesh.initialize_distributed(device="cuda")


def test_mesh_drives_the_card_its_group_was_bound_to(monkeypatch):
    """A CUDA mesh over a running group takes the card
    ``initialize_distributed`` bound that group to, not ``LOCAL_RANK``;
    after the group ends, ``LOCAL_RANK`` again."""
    import torch
    import torch.distributed as dist

    monkeypatch.setenv("LOCAL_RANK", "3")
    tmesh.initialize_distributed(device="cpu")
    try:
        monkeypatch.setitem(tmesh._bound, "device", torch.device("cuda", 1))
        assert tmesh._local_device("cuda") == torch.device("cuda", 1)
        assert tmesh._local_device("cuda", [2]) == torch.device("cuda", 2)
    finally:
        dist.destroy_process_group()
    assert tmesh._local_device("cuda") == torch.device("cuda", 3)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_layout(port, world):
    spec = default_mesh_spec(world)
    assert tuple(make_mesh(world).devices.shape) == (spec.data, spec.model)
    for rank, res in enumerate(port[world][1]):
        assert tuple(res["mesh_layout"]["shape"]) == (spec.data, spec.model)
        assert tuple(res["mesh_layout"]["position"]) == (
            rank, rank // spec.model, rank % spec.model)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_folded_features(port, inputs, world):
    res = _result(port, world, "extract_folded")
    _same_on_every_rank(port, world, "extract_folded", ["sharded"])
    run = make_sharded_feature_fn(make_mesh(world), init_backbone_params(0, TINY), TINY)
    want = np.asarray(run(jnp.asarray(inputs["patches"])))
    np.testing.assert_allclose(res["sharded"], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["sharded"], res["single"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_module_features(port, inputs, world):
    res = _result(port, world, "extract_module")
    variables = init_backbone_params(0, TINY)
    model = EfficientNetBackbone(config=TINY)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(inputs["patches"])))
    np.testing.assert_allclose(res["sharded"], want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_extractor(port, inputs, world):
    res = _result(port, world, "extractor_mesh")
    _same_on_every_rank(port, world, "extractor_mesh", ["mesh"])
    jx = jext.build_extractor(init_backbone_params(0, TINY), TINY,
                              mesh=make_mesh(world), **EXTRACTOR_OPTS)
    for got, many, single, (image, pts) in zip(res["mesh"], res["many"],
                                               res["single"], inputs["images"]):
        want = jx.extract_features(image, pts)
        assert got.shape == want.shape == (len(pts), TINY.feature_dim)
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 1e-4, rel
        np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(many, single, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_head(port, inputs, world):
    res = _result(port, world, "sharded_head")
    _same_on_every_rank(port, world, "sharded_head", ["proba"])
    head = JHeadParams(*inputs["head"])
    want = np.asarray(jhead_apply(head.as_pytree(),
                                  jnp.asarray(inputs["head_features"])))
    assert res["proba"].dtype == np.float64
    np.testing.assert_allclose(res["proba"], want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(res["proba"].sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_predictor(port, inputs, world):
    """13 rows: the pad to the rank multiple is dropped."""
    res = _result(port, world, "sharded_predictor")
    jpred = load_sharded_predictor(inputs["artifact"], make_mesh(world))
    want = jpred.predict_proba(inputs["artifact_features"])
    assert res["mesh"].shape == want.shape == (13, 3)
    np.testing.assert_allclose(res["mesh"], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["mesh"], res["single"], rtol=0, atol=1e-7)
    assert list(res["classes"]) == list(jpred.classes)


@pytest.mark.parametrize("layers", TRAINER_LAYERS, ids=["even", "uneven"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_head_trainer(port, inputs, world, layers):
    name = "trainer_step" if layers == TRAINER_LAYERS[0] else "trainer_step_uneven"
    res = _result(port, world, name)
    _same_on_every_rank(port, world, name, ["W", "b", "losses"])
    init = jax.tree.map(jnp.asarray, inputs["trainer_init"][layers])
    x_eval = inputs["trainer_batches"][layers][0][0][:8]
    losses = []
    if name == "trainer_step":
        trainer = ShardedHeadTrainer(make_mesh(world), layers, learning_rate=1e-3,
                                     alpha=0.01)
        params = trainer.shard_params(init)
        opt_state = trainer.init_opt_state(params)
        for x, y, w in inputs["trainer_batches"][layers]:
            params, opt_state, loss = trainer.train_step(
                params, opt_state, *trainer.place_batch(x, y, w), 14.0)
            losses.append(float(loss))
        want_proba = trainer.predict_proba(params, jnp.asarray(x_eval))
    else:
        # The JAX trainer's device_put refuses a width the model axis does
        # not divide; the port pads it. Held to the JAX single-device step
        # of tests/parallel/test_sharded.py.
        params, opt = init, optax.adam(1e-3, eps_root=0.0)
        opt_state = opt.init(params)
        for x, y, w in inputs["trainer_batches"][layers]:
            params, opt_state, loss = jsharded.TestShardedHeadTrainer._reference_step(
                None, params, opt_state, jnp.asarray(x), jnp.asarray(y),
                jnp.asarray(w), 14.0, opt, 0.01)
            losses.append(float(loss))
        logits = jnp.asarray(x_eval)
        for i, (wi, bi) in enumerate(zip(params["W"], params["b"])):
            logits = logits @ wi + bi
            logits = jax.nn.relu(logits) if i < len(params["W"]) - 1 else logits
        want_proba = jax.nn.softmax(logits, axis=1)
    np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-5)
    for got, want in zip(res["W"] + res["b"], params["W"] + params["b"]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["proba"], np.asarray(want_proba),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["proba"].sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_streamed_partial_fit_on_mesh(port, inputs, world):
    res = _result(port, world, "stream_fit")
    X, y, classes = inputs["stream"]
    clf = JMLP((8,), batch_size=15, random_state=3, init="sklearn",
               mesh=make_mesh(world))
    for _ in range(3):
        clf.partial_fit(X, y, classes=classes)
    assert list(res["loss_curve"]) == pytest.approx(clf.loss_curve_, rel=2e-5)
    for got, want in zip(res["coefs"], clf.coefs_):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(res["proba"], clf.predict_proba(X),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("world", WORLDS)
def test_resident_on_mesh(port, inputs, world, dtype):
    name = {"float32": "resident_f32", "bfloat16": "resident_bf16",
            "int8": "resident_int8"}[dtype]
    res = _result(port, world, name)
    _same_on_every_rank(port, world, name, ["coefs", "proba", "eval_counts"])
    X, y, classes, orders = inputs["resident"]
    # Row-sharded: each rank holds ceil(300 / world) rows.
    assert int(res["buffer_rows"]) == -(-len(X) // world)
    clf = JMLP((12,), random_state=2, init="sklearn", mesh=make_mesh(world))
    clf.set_resident_features(X, dtype=dtype)
    for order in orders:
        for s in range(0, len(order), 128):
            idx = order[s:s + 128]
            clf.partial_fit_resident(idx, y[idx], classes=classes)
    assert list(res["loss_curve"]) == pytest.approx(clf.loss_curve_, abs=1e-6)
    for got, want in zip(res["coefs"], clf.coefs_):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    probe = np.arange(0, len(X), 7)
    np.testing.assert_allclose(res["proba"], clf.predict_proba_resident(probe),
                               rtol=1e-5, atol=1e-6)
    want_counts = clf.eval_counts_resident(probe, np.searchsorted(clf.classes_, y[probe]))
    assert res["eval_counts"][0] == want_counts[0]
    assert res["eval_counts"][1] == pytest.approx(want_counts[1], rel=1e-5)


@pytest.mark.parametrize("world,resident", [(2, False), (4, True)])
def test_trainer_on_mesh(port, inputs, tmp_path, world, resident):
    """Streamed at 2 ranks, resident at 4 (each JAX mesh trainer compiles
    for seconds)."""
    res = _result(port, world, "trainer_mesh")
    jlabels, _ = synthetic_tasks(tmp_path, n_images=40, pts_per_image=10,
                                 n_classes=3, dim=8, seed=0)

    class JMeshTrainer(JTrainer):
        def _make_classifier(self, class_weight):
            return JMLP(hidden_layer_sizes=(16,), learning_rate_init=1e-2,
                        class_weight=class_weight, random_state=0,
                        init="sklearn", mesh=self.mesh)

    _, _, msg = JMeshTrainer(batch_size=64, mesh=make_mesh(world),
                             device_resident=resident)(
        jlabels, nbr_epochs=3, pc_models=[])
    assert list(res[f"ref_accs_{resident}"]) == pytest.approx(msg.ref_accs, abs=1e-6)
    assert float(res[f"acc_{resident}"]) == pytest.approx(msg.acc, abs=1e-6)


@pytest.mark.parametrize("case,message", [
    ("indivisible_extract", "ValueError: batch size .* is not divisible"),
    ("fused_with_mesh", "ValueError: fused backbone_impl is single-device"),
    ("indivisible_backbone_batch", "ValueError: backbone_batch=.* must be divisible"),
    ("head_indivisible", "ValueError: batch size .* is not divisible"),
    ("head_width", "ValueError: features must be"),
    ("world_size_mismatch", "SystemExit: .*torchrun --nproc-per-node"),
])
@pytest.mark.parametrize("world", WORLDS)
def test_raises(port, world, case, message):
    import re

    got = str(_result(port, world, "raises")[case])
    assert re.match(message, got), got


@pytest.mark.parametrize("world", WORLDS)
def test_predict_features_mesh_devices(port, inputs, world):
    """``--mesh-devices`` under one process per rank: exit 0 everywhere,
    rank 0 writes the CSV, the JAX sharded predictor's scores."""
    assert [int(r["predict_cli"]["rc"]) for r in port[world][1]] == [0] * world
    run_dir = port[world][0]
    with open(run_dir / "predictions.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    want = jbp.predict_feature_files(
        load_sharded_predictor(inputs["artifact"], make_mesh(world)),
        inputs["feature_files"], top_n=3, batch_size=5)
    assert len(rows) == len(want) == 13
    for row, w in zip(rows, want):
        assert (row["row"], row["col"]) == (str(w.row), str(w.col))
        for i, (label, score) in enumerate(zip(w.labels, w.scores), start=1):
            assert row[f"label_{i}"] == label
            assert float(row[f"score_{i}"]) == pytest.approx(score, abs=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_build_feature_bucket_mesh_devices(port, inputs, tmp_path, world):
    """``--mesh-devices`` under one process per rank: exit 1 everywhere (the
    corrupt image), one copy of every file and log record, written by rank
    0; the features within 1e-5 of the single-process port CLI's
    (``folded``) and rel 1e-4 of the JAX mesh builder's."""
    assert [int(r["bucket_cli"]["rc"]) for r in port[world][1]] == [1] * world
    run_dir = port[world][0]
    meshed = TStore(run_dir / "store")
    single = populate(TStore(tmp_path / "single"), corrupt=True)
    with tset.override_settings(object_store_root=str(tmp_path / "single")):
        assert build_feature_bucket.main(
            [*_bucket_argv(inputs["weights"], tmp_path), "--backbone-impl",
             "folded"]) == 1
    jstore = populate(JStore(tmp_path / "jax"), corrupt=True)
    jfb.FeatureBucketBuilder(jstore, SRC, DST, jext.build_extractor(
        init_backbone_params(0, TINY), TINY, mesh=make_mesh(world),
        backbone_batch=8)).run(["1", "2"])
    keys = sorted(meshed.list_keys(DST))
    assert keys == sorted(single.list_keys(DST)) == sorted(jstore.list_keys(DST))
    features = [k for k in keys if k.endswith(".features.npz")]
    assert len(features) == 4
    for key in features:
        (rc, got), (rc_s, want), (rc_j, jax_want) = (
            read_feature_file(io.BytesIO(store.get_bytes(DST, key)))
            for store in (meshed, single, jstore))
        np.testing.assert_array_equal(rc, rc_s)
        np.testing.assert_array_equal(rc, rc_j)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert np.abs(got - jax_want).max() / np.abs(jax_want).max() <= 1e-4
    progress, errors = log_records(run_dir)
    want_progress, want_errors = log_records(tmp_path)
    assert sorted(map(str, progress)) == sorted(map(str, want_progress))
    assert [e["image_id"] for e in errors] == [e["image_id"] for e in want_errors]
