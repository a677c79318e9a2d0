"""The port's device-resident classifier paths and its fixed-shape step, on
the CPU, against the JAX classifier and against the port's streamed path.

Tolerances, each stated where it is asserted:

- resident against streamed in the port, on one device: bitwise (weights,
  biases, ``loss_curve_``, probabilities), with class weights and a padded
  tail mini-batch;
- resident training against the JAX resident classifier from the shared
  sklearn init: weights within rtol 1e-4 / atol 1e-5, ``loss_curve_``
  within rel 1e-5 (the streamed tests' bounds);
- the storage bits (bf16, int8 rows and scales) equal the JAX buffer's;
- ``eval_counts_resident``: the correct count exact, the loss sum within
  rel 1e-5 of the numpy log loss (the JAX test's bound, float32 reduction);
- ``predict_indices_resident`` equals the argmax of
  ``predict_proba_resident``;
- bf16 storage behind the 0.999 min-cosine gate.
"""

import copy
import pickle
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.train.mlp_classifier import MLPClassifier as JMLP
from mermaid_classifier_tpu_torch.inference.head import HeadParams, head_apply
from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier as TMLP
from mermaid_classifier_tpu_torch.train.trainer import _FilledPrefix, log_loss

DTYPES = ("float32", "bfloat16", "int8")


def _data(n=600, dim=12, k=4, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, size=(k, dim)).astype(np.float32)
    y_idx = rng.integers(0, k, n)
    X = (centers[y_idx] + rng.normal(0, 0.5, size=(n, dim))).astype(np.float32)
    return X, np.asarray([f"c{i}" for i in y_idx])


def _clf(**kw):
    return TMLP(device="cpu", **{"hidden_layer_sizes": (16, 8),
                                 "learning_rate_init": 1e-2,
                                 "random_state": 3, **kw})


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _assert_same(a, b):
    assert a.loss_curve_ == b.loss_curve_
    for wa, wb in zip(a.coefs_ + a.intercepts_, b.coefs_ + b.intercepts_):
        np.testing.assert_array_equal(wa, wb)


def test_resident_matches_streamed_bitwise():
    """Three epochs of shuffled 256-row calls (a padded tail each epoch)."""
    X, y = _data()
    classes = sorted(set(y.tolist()))
    streamed, resident = _clf(), _clf()
    resident.set_resident_features(X)
    rng = np.random.default_rng(0)
    for _ in range(3):
        order = rng.permutation(len(X))
        for start in range(0, len(X), 256):
            idx = order[start:start + 256]
            streamed.partial_fit(X[idx], y[idx], classes=classes)
            resident.partial_fit_resident(idx, y[idx], classes=classes)
    _assert_same(streamed, resident)
    np.testing.assert_array_equal(streamed.predict_proba(X[:50]),
                                  resident.predict_proba(X[:50]))
    np.testing.assert_array_equal(resident.predict_proba_resident(np.arange(50)),
                                  resident.predict_proba(X[:50]))


@pytest.mark.parametrize("n", [130, 200, 17])
def test_resident_with_class_weights_and_padding(n):
    """n 130 pads a tail of 70 rows, 200 fills one batch, 17 runs one batch
    of 17: class weights, bitwise equal."""
    X, y = _data(n=n)
    classes = sorted(set(y.tolist()) | {"c0", "c1", "c2", "c3"})
    weights = {c: 1.0 + i for i, c in enumerate(classes)}
    streamed, resident = (_clf(hidden_layer_sizes=(8,), random_state=1,
                               class_weight=weights) for _ in range(2))
    resident.set_resident_features(X)
    for _ in range(2):
        streamed.partial_fit(X, y, classes=classes)
        resident.partial_fit_resident(np.arange(len(X)), y, classes=classes)
    _assert_same(streamed, resident)


@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_training_matches_jax(dtype):
    """The JAX resident classifier and the port's, from the sklearn init,
    on the same storage: rtol 1e-4 / atol 1e-5, loss rel 1e-5."""
    X, y = _data(n=333)
    classes = sorted(set(y.tolist()))
    kw = dict(hidden_layer_sizes=(16, 8), learning_rate_init=1e-2,
              random_state=3, init="sklearn", alpha=0.01,
              class_weight={c: 1.0 + i for i, c in enumerate(classes)})
    jclf, tclf = JMLP(**kw), TMLP(device="cpu", **kw)
    jclf.set_resident_features(X, dtype=dtype)
    tclf.set_resident_features(X, dtype=dtype)
    rng = np.random.default_rng(1)
    for _ in range(3):
        order = rng.permutation(len(X)).astype(np.int32)
        for start in range(0, len(X), 150):
            idx = order[start:start + 150]
            jclf.partial_fit_resident(idx, y[idx], classes=classes)
            tclf.partial_fit_resident(idx, y[idx], classes=classes)
    for got, want in zip(tclf.coefs_ + tclf.intercepts_,
                         jclf.coefs_ + jclf.intercepts_):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert tclf.loss_curve_ == pytest.approx(jclf.loss_curve_, rel=1e-5)
    idx = np.arange(100)
    np.testing.assert_allclose(tclf.predict_proba_resident(idx),
                               jclf.predict_proba_resident(idx), atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_buffer_bits_equal_jax(dtype):
    X, _ = _data(n=237, dim=16)
    X[3] = 0.0  # an all-zero row takes scale 1.0
    X[4] = 1e-39  # a subnormal absmax too
    jclf, tclf = JMLP((4,)), TMLP((4,), device="cpu")
    jclf.set_resident_features(X, dtype=dtype)
    tclf.set_resident_features(X, dtype=dtype)
    assert str(tclf._resident_X.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(
        _bits(tclf._resident_X),
        np.asarray(jclf._resident_X).view(np.uint16 if dtype == "bfloat16"
                                          else np.asarray(jclf._resident_X).dtype))
    if dtype == "int8":
        np.testing.assert_array_equal(tclf._resident_scale.numpy(),
                                      np.asarray(jclf._resident_scale))
        assert tclf._resident_scale[3] == 1.0 and tclf._resident_scale[4] == 1.0
    else:
        assert tclf._resident_scale is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_slab_upload_equals_one_shot(dtype):
    """Slabs of 8 rows (a ragged last one) give the buffer of one slab."""
    X, _ = _data(n=237, dim=16)
    clf = TMLP((4,), device="cpu")
    scale = TMLP._int8_row_scales(X) if dtype == "int8" else None
    torch_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "int8": torch.int8}[dtype]
    one = clf._upload_rows(X, torch_dtype, row_scale=scale)
    slabs = clf._upload_rows(X, torch_dtype, row_scale=scale,
                             chunk_bytes=8 * 16 * one.element_size())
    assert torch.equal(one, slabs)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_storage_upload_equals_f32_upload(dtype):
    """set_resident_features_storage on staged rows gives the buffer of
    set_resident_features on the f32 rows."""
    X, _ = _data(n=100, dim=16)
    direct = TMLP((4,), device="cpu").set_resident_features(X, dtype=dtype)
    if dtype == "int8":
        scale = TMLP._int8_row_scales(X)
        stored = TMLP._quantize_matrix_int8(X, (1.0 / scale).astype(np.float32))
    else:
        scale, stored = None, torch.from_numpy(X).to(torch.bfloat16)
    staged = TMLP((4,), device="cpu").set_resident_features_storage(stored, scale)
    assert torch.equal(staged._resident_X, direct._resident_X)
    if dtype == "int8":
        assert torch.equal(staged._resident_scale, direct._resident_scale)
    assert staged._resident_dtype == dtype and staged._resident_n_rows == 100


def test_pipelined_upload_equals_direct():
    """Slabs streamed behind a concurrent out-of-order fill."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 32)).astype(np.float32)
    staged = np.zeros_like(X)
    tracker = _FilledPrefix(64)

    def fill():
        for k in [3, 0, 1, 2, 5, 4, 7, 6]:
            staged[k * 8: (k + 1) * 8] = X[k * 8: (k + 1) * 8]
            tracker.add(k * 8, 8)

    th = threading.Thread(target=fill, daemon=True)
    th.start()
    got = TMLP((4,), device="cpu")._upload_rows(
        staged, torch.float32, wait_rows=tracker.wait, chunk_bytes=8 * 32 * 4)
    th.join(timeout=5)
    assert not th.is_alive()
    np.testing.assert_array_equal(got.numpy(), X)


def test_wait_rows_guards_converting_inputs():
    """A non-f32 input (an f64 buffer, an f64 scale vector) is converted by
    a copy, so the upload waits for the whole fill before converting."""
    rng = np.random.default_rng(1)
    final = rng.standard_normal((16, 8))
    staged = np.zeros((16, 8), np.float64)
    tracker = _FilledPrefix(16)

    def fill():
        staged[:] = final
        tracker.add(0, 16)

    th = threading.Thread(target=fill, daemon=True)
    clf = TMLP((4,), device="cpu")
    th.start()
    clf.set_resident_features(staged, wait_rows=tracker.wait)
    th.join(timeout=5)
    np.testing.assert_array_equal(clf._resident_X.numpy(), final.astype(np.float32))

    q = rng.integers(-127, 127, (16, 8)).astype(np.int8)
    scale64 = np.zeros(16, np.float64)
    tracker2 = _FilledPrefix(16)

    def fill2():
        scale64[:] = np.arange(1, 17)
        tracker2.add(0, 16)

    th2 = threading.Thread(target=fill2, daemon=True)
    clf2 = TMLP((4,), device="cpu")
    th2.start()
    clf2.set_resident_features_storage(q, scale64, wait_rows=tracker2.wait)
    th2.join(timeout=5)
    np.testing.assert_array_equal(clf2._resident_scale.numpy(),
                                  np.arange(1, 17, dtype=np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_predict_indices_resident_matches_proba_argmax(dtype):
    X, y = _data()
    clf = _clf()
    clf.set_resident_features(X, dtype=dtype)
    idx = np.arange(len(X), dtype=np.int32)
    clf.partial_fit_resident(idx, y, classes=sorted(set(y.tolist())))
    got = clf.predict_indices_resident(idx)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, clf.predict_proba_resident(idx).argmax(axis=1))
    np.testing.assert_array_equal(clf.predict_resident(idx),
                                  clf.classes_[clf.predict_proba_resident(idx).argmax(1)])


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_counts_resident_matches_numpy_metrics(dtype):
    X, y = _data()
    clf = _clf()
    clf.set_resident_features(X, dtype=dtype)
    idx = np.arange(len(X), dtype=np.int32)
    clf.partial_fit_resident(idx, y, classes=sorted(set(y.tolist())))
    pos = {c: i for i, c in enumerate(clf.classes_)}
    y_idx = np.asarray([pos[v] for v in y], dtype=np.int32)
    counts = clf.eval_counts_resident(idx, y_idx)
    assert counts.shape == (2,) and counts.dtype == np.float32
    proba = clf.predict_proba_resident(idx)
    assert float(counts[0]) == float((proba.argmax(axis=1) == y_idx).sum())
    host = log_loss(y, proba, labels=list(clf.classes_))
    assert float(counts[1]) / len(idx) == pytest.approx(host, rel=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_counts_resident_unknown_label_rows(dtype):
    """Rows labelled -1 count wrong and add no loss: masking 10 rows equals
    leaving them out (count exact, loss sum rel 1e-6)."""
    X, y = _data()
    clf = _clf()
    clf.set_resident_features(X, dtype=dtype)
    idx = np.arange(len(X), dtype=np.int32)
    clf.partial_fit_resident(idx, y, classes=sorted(set(y.tolist())))
    pos = {c: i for i, c in enumerate(clf.classes_)}
    y_idx = np.asarray([pos[v] for v in y], dtype=np.int32)
    masked = y_idx.copy()
    masked[:10] = -1
    full = clf.eval_counts_resident(idx, masked)
    tail = clf.eval_counts_resident(idx[10:], y_idx[10:])
    assert float(full[0]) == float(tail[0])
    assert float(full[1]) == pytest.approx(float(tail[1]), rel=1e-6)


def test_eval_counts_match_jax_from_the_same_weights():
    """The port's fused eval and the JAX one over the same weights and
    rows: the count exact, the loss sum within rel 1e-5."""
    X, y = _data()
    classes = sorted(set(y.tolist()))
    jclf = JMLP((16, 8), random_state=2, init="sklearn")
    jclf.set_resident_features(X)
    idx = np.arange(len(X), dtype=np.int32)
    jclf.partial_fit_resident(idx, y, classes=classes)
    from mermaid_classifier_tpu_torch.train.mlp_classifier import (
        classifier_from_arrays,
    )

    tclf = classifier_from_arrays(jclf.coefs_, jclf.intercepts_, classes=classes,
                                  device="cpu")
    tclf.set_resident_features(X)
    y_idx = np.searchsorted(classes, y).astype(np.int32)
    y_idx[::7] = -1
    got, want = tclf.eval_counts_resident(idx, y_idx), jclf.eval_counts_resident(idx, y_idx)
    assert got[0] == want[0]
    assert got[1] == pytest.approx(float(want[1]), rel=1e-5)
    np.testing.assert_array_equal(tclf.predict_indices_resident(idx),
                                  jclf.predict_indices_resident(idx))


@pytest.mark.parametrize("calibration", ["sigmoid", "temperature"])
def test_predict_proba_resident_head_is_head_apply(calibration):
    """The artifact's head over resident rows equals head_apply on the same
    rows (bitwise on one device), for both calibrations."""
    X, y = _data(n=120)
    clf = _clf()
    clf.set_resident_features(X)
    clf.partial_fit_resident(np.arange(120), y, classes=sorted(set(y.tolist())))
    k = len(clf.classes_)
    if calibration == "sigmoid":
        params = HeadParams(clf.coefs_, clf.intercepts_,
                            a=np.linspace(-3, -1, k), b=np.linspace(0.1, 0.4, k))
    else:
        params = HeadParams(clf.coefs_, clf.intercepts_, temperature=1.7)
    tree = params.as_tensors("cpu")
    idx = np.asarray([5, 0, 119, 7])
    got = clf.predict_proba_resident_head(tree, idx)
    want = head_apply(tree, torch.from_numpy(X[idx])).numpy().astype(np.float64)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # No fitted state needed: the params are the model.
    bare = TMLP((4,), device="cpu").set_resident_features(X)
    np.testing.assert_array_equal(bare.predict_proba_resident_head(tree, idx), want)


def test_bf16_buffer_behind_cosine_gate():
    """The same trained params over bf16-stored rows against the host f32
    rows: min cosine >= 0.999; the f32- and bf16-trained models stay close
    (min cosine >= 0.98, loss rtol 5e-2; the JAX test's quality band)."""
    X, y = _data(n=400)
    classes = sorted(set(y.tolist()))
    f32, bf16 = _clf(), _clf()
    f32.set_resident_features(X)
    bf16.set_resident_features(X, dtype="bfloat16")
    idx = np.arange(len(X))
    for _ in range(3):
        f32.partial_fit_resident(idx, y, classes=classes)
        bf16.partial_fit_resident(idx, y, classes=classes)

    def min_cosine(a, b):
        num = np.sum(a * b, axis=1)
        den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
        return float(np.min(num / np.maximum(den, 1e-12)))

    p_host = bf16.predict_proba(X[:100])
    assert min_cosine(p_host, bf16.predict_proba_resident(idx[:100])) >= 0.999
    assert min_cosine(f32.predict_proba(X[:100]), p_host) >= 0.98
    np.testing.assert_allclose(f32.loss_curve_, bf16.loss_curve_, rtol=5e-2)


ERRORS = {
    "no buffer": lambda clf, X, y: clf.partial_fit_resident(np.arange(5), y[:5],
                                                            classes=sorted(set(y))),
    "out of range": lambda clf, X, y: (clf.set_resident_features(X),
                                       clf.partial_fit_resident(np.asarray([0, 99]), y[:2],
                                                                classes=sorted(set(y)))),
    "labels": lambda clf, X, y: (clf.set_resident_features(X),
                                 clf.partial_fit_resident(np.asarray([0, 1]), y[:3],
                                                          classes=sorted(set(y)))),
    "2-D indices": lambda clf, X, y: (clf.set_resident_features(X),
                                      clf.partial_fit_resident(np.zeros((2, 2)), y[:4])),
    "dtype": lambda clf, X, y: clf.set_resident_features(X, dtype="float16"),
    "3-D X": lambda clf, X, y: clf.set_resident_features(X[None]),
    "no scale": lambda clf, X, y: clf.set_resident_features_storage(
        np.zeros((4, 3), np.int8)),
    "bad storage": lambda clf, X, y: clf.set_resident_features_storage(
        np.zeros((4, 3), np.float16)),
    "unfitted predict": lambda clf, X, y: (clf.set_resident_features(X),
                                           clf.predict_proba_resident(np.arange(3))),
    "eval shape": lambda clf, X, y: (clf.set_resident_features(X),
                                     clf.partial_fit_resident(np.arange(20), y,
                                                              classes=sorted(set(y))),
                                     clf.eval_counts_resident(np.arange(20),
                                                              np.zeros(5, np.int32))),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_resident_errors_match_jax(case):
    X, y = _data(n=20)
    with pytest.raises(Exception) as jerr:
        ERRORS[case](JMLP((8,), random_state=0), X, y)
    with pytest.raises(Exception) as terr:
        ERRORS[case](TMLP((8,), random_state=0, device="cpu"), X, y)
    assert terr.type is jerr.type
    first = str(jerr.value).split(" (")[0].split(" [")[0]
    assert str(terr.value).startswith(first[:24]), (str(terr.value), str(jerr.value))


def test_resident_eval_rejects_out_of_range_rows():
    X, y = _data(n=20)
    clf = TMLP((8,), random_state=0, device="cpu").set_resident_features(X)
    clf.partial_fit_resident(np.arange(20), y, classes=sorted(set(y)))
    with pytest.raises(ValueError, match="out of range"):
        clf.predict_proba_resident(np.asarray([0, 20]))


def test_snapshot_shares_and_pickle_drops_the_buffer():
    """A deepcopy shares the resident buffer and its scale (a copy would
    double device memory) but clones the parameters and moments; a pickle
    drops the buffer and keeps the model."""
    X, y = _data(n=64)
    clf = TMLP((8,), random_state=0, device="cpu")
    clf.set_resident_features(X, dtype="int8")
    clf.partial_fit_resident(np.arange(64), y, classes=sorted(set(y)))
    snap = copy.deepcopy(clf)
    assert snap._resident_X is clf._resident_X
    assert snap._resident_scale is clf._resident_scale
    assert snap._params["W"][0] is not clf._params["W"][0]
    assert snap._adam["mu"]["W"][0] is not clf._adam["mu"]["W"][0]
    assert not getattr(snap, "_runners", {})
    state = clf.__getstate__()
    for key in ("_resident_X", "_resident_scale", "_runners", "_stream_X",
                "_class_w_dev", "_adam"):
        assert key not in state
    clone = pickle.loads(pickle.dumps(clf))
    assert getattr(clone, "_resident_X", None) is None
    np.testing.assert_array_equal(clf.predict(X[:10]), clone.predict(X[:10]))
    # The snapshot trains on as the original would.
    twin = copy.deepcopy(snap)
    snap.partial_fit_resident(np.arange(64), y)
    twin.partial_fit_resident(np.arange(64), y)
    _assert_same(snap, twin)


def test_step_state_and_runner_reuse():
    """Adam's count is a device tensor; a second call of the same geometry
    reuses the runner; new state (``_set_state``) drops it; a larger call
    grows its buffers."""
    X, y = _data(n=400)
    clf = _clf(batch_size=50)
    clf.set_resident_features(X)
    classes = sorted(set(y.tolist()))
    clf.partial_fit_resident(np.arange(100), y[:100], classes=classes)
    assert isinstance(clf._adam["count"], torch.Tensor)
    assert clf._adam_state()["count"] == 2
    (runner,) = clf._runners.values()
    clf.partial_fit_resident(np.arange(100, 200), y[100:200])
    assert list(clf._runners.values()) == [runner]
    clf.partial_fit_resident(np.arange(400), y)
    (grown,) = clf._runners.values()
    assert grown is not runner and grown.capacity >= 8
    assert clf._adam_state()["count"] == 12
    clf._set_state(clf.coefs_, clf.intercepts_, clf._adam_state())
    assert clf._runners == {}
    clf.set_resident_features(X[:50])
    assert clf._resident_n_rows == 50


def test_streamed_staging_buffer_grows_and_is_reused():
    """The streamed call's rows go to a staging buffer (whole 1024-row
    blocks, a quarter to spare) that keeps its address while calls fit."""
    X, y = _data(n=1300)
    clf = _clf()
    clf.partial_fit(X[:100], y[:100], classes=sorted(set(y.tolist())))
    buf = clf._stream_X
    assert buf.shape[0] == 1024
    clf.partial_fit(X[100:1100], y[100:1100])
    assert clf._stream_X is buf
    clf.partial_fit(X, y)
    assert clf._stream_X is not buf and clf._stream_X.shape[0] == 2048
