"""The port's MLPClassifier against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both. Tolerances, each stated where
it is asserted:

- training from the same weights (the sklearn init, bit for bit the same in
  both, or weights and Adam state carried across from a JAX run): weights
  and biases within rtol 1e-4 / atol 1e-5 (the JAX test's bound against its
  numpy Adam, tests/train/test_mlp_classifier.py), ``loss_curve_`` within
  rel 1e-5;
- ``fit``: the same ``n_iter_``, ``loss_curve_`` within rel 1e-4;
- ``predict_proba`` from the same weights: within 1e-6 max abs;
- errors: the same exception type and message.
"""

import copy
import pickle

import jax
import numpy as np
import pytest
import torch

from mermaid_classifier_tpu.train.mlp_classifier import MLPClassifier as JMLP
from mermaid_classifier_tpu_torch.train import mlp_classifier as tmlp
from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier as TMLP
from mermaid_classifier_tpu_torch.train.mlp_classifier import classifier_from_arrays

LABELS = np.array(["c0", "c1", "c2"])
CLASS_WEIGHT = {"c0": 0.5, "c1": 2.0, "c2": 1.0}


def _data(n=53, d=12, k=3, seed=0):
    """n rows, k classes with shifted means; 53 % 16 leaves a tail of 5."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=n)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, :k] += 1.5 * np.eye(k, dtype=np.float32)[y]
    return X, LABELS[:k][y]


def _adam_arrays(jclf) -> dict:
    """The JAX classifier's optax Adam state as numpy arrays."""
    state = jclf._opt_state[0]
    return {
        "count": int(state.count),
        "mu": jax.tree.map(np.asarray, state.mu),
        "nu": jax.tree.map(np.asarray, state.nu),
    }


def _assert_same_training(jclf, tclf, loss_rel=1e-5):
    for got, want in zip(tclf.coefs_ + tclf.intercepts_,
                         jclf.coefs_ + jclf.intercepts_):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert tclf.loss_curve_ == pytest.approx(jclf.loss_curve_, rel=loss_rel)
    assert tclf.n_iter_ == jclf.n_iter_


HYPER = dict(batch_size=16, learning_rate_init=0.01, alpha=0.3, random_state=11)


@pytest.mark.parametrize("hidden", [(8,), (16, 8)])
@pytest.mark.parametrize("class_weight", [None, CLASS_WEIGHT])
def test_partial_fit_from_sklearn_init_matches_jax(hidden, class_weight):
    """Three partial_fit calls from the shared sklearn init, uneven tail."""
    X, y = _data()
    kw = dict(hidden_layer_sizes=hidden, init="sklearn", class_weight=class_weight,
              **HYPER)
    jclf, tclf = JMLP(**kw), TMLP(device="cpu", **kw)
    for _ in range(3):
        jclf.partial_fit(X, y, classes=list(LABELS))
        tclf.partial_fit(X, y, classes=list(LABELS))
    _assert_same_training(jclf, tclf)


@pytest.mark.parametrize("hidden", [(8,), (16, 8)])
def test_partial_fit_continues_carried_jax_run(hidden):
    """Weights and Adam state carried across after one JAX partial_fit;
    three more calls on each side, class weights, alpha 0.3, n 53 batch 16."""
    X, y = _data(seed=1)
    kw = dict(hidden_layer_sizes=hidden, class_weight=CLASS_WEIGHT, **HYPER)
    jclf = JMLP(**kw)
    jclf.partial_fit(X, y, classes=list(LABELS))
    adam = _adam_arrays(jclf)
    assert adam["count"] == 4
    tclf = classifier_from_arrays(
        jclf.coefs_, jclf.intercepts_, classes=LABELS, adam=adam, device="cpu",
        **{k: v for k, v in kw.items() if k != "hidden_layer_sizes"},
    )
    for _ in range(3):
        jclf.partial_fit(X, y)
        tclf.partial_fit(X, y)
    for got, want in zip(tclf.coefs_ + tclf.intercepts_,
                         jclf.coefs_ + jclf.intercepts_):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert tclf.loss_curve_ == pytest.approx(jclf.loss_curve_[1:], rel=1e-5)
    assert tclf._adam_state()["count"] == _adam_arrays(jclf)["count"] == 16


@pytest.mark.parametrize("hidden", [(8,), (16, 8)])
def test_sklearn_init_is_bitwise_the_jax_init(hidden):
    clfs = [JMLP(hidden_layer_sizes=hidden, init="sklearn", random_state=5),
            TMLP(hidden_layer_sizes=hidden, init="sklearn", random_state=5,
                 device="cpu")]
    for clf in clfs:
        clf.classes_, clf.n_features_in_ = LABELS, 12
        clf._init_params()
    for got, want in zip(clfs[1].coefs_ + clfs[1].intercepts_,
                         clfs[0].coefs_ + clfs[0].intercepts_):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_reference_init_is_seeded_glorot_with_zero_biases():
    def init(seed):
        clf = TMLP(hidden_layer_sizes=(30, 20), random_state=seed, device="cpu")
        clf.classes_, clf.n_features_in_ = LABELS, 40
        clf._init_params()
        return clf

    a, b, c = init(3), init(3), init(4)
    for w_a, w_b, w_c in zip(a.coefs_, b.coefs_, c.coefs_):
        np.testing.assert_array_equal(w_a, w_b)
        assert not np.array_equal(w_a, w_c)
        limit = np.sqrt(6.0 / sum(w_a.shape))
        assert np.abs(w_a).max() <= limit and np.abs(w_a).max() > 0.9 * limit
    for bias in a.intercepts_:
        np.testing.assert_array_equal(bias, 0.0)


@pytest.mark.parametrize("class_weight", [None, CLASS_WEIGHT])
def test_fit_early_stopping_matches_jax(class_weight):
    X, y = _data(n=90, d=8, seed=2)
    kw = dict(hidden_layer_sizes=(16,), init="sklearn", random_state=0,
              max_iter=60, tol=1e-2, n_iter_no_change=3,
              learning_rate_init=0.01, class_weight=class_weight)
    jclf, tclf = JMLP(**kw).fit(X, y), TMLP(device="cpu", **kw).fit(X, y)
    assert jclf.n_iter_ < 60  # the stop fired
    assert tclf.n_iter_ == jclf.n_iter_
    assert tclf.loss_curve_ == pytest.approx(jclf.loss_curve_, rel=1e-4)
    assert tclf.best_loss_ == pytest.approx(jclf.best_loss_, rel=1e-4)
    # fit starts afresh on a trained instance.
    tclf.fit(X, y)
    assert tclf.n_iter_ == jclf.n_iter_


def test_predict_proba_matches_jax():
    X, y = _data(n=120, seed=3)
    jclf = JMLP(hidden_layer_sizes=(16, 8), random_state=2)
    for _ in range(4):
        jclf.partial_fit(X, y, classes=list(LABELS))
    tclf = classifier_from_arrays(jclf.coefs_, jclf.intercepts_, classes=LABELS,
                                  device="cpu")
    want = jclf.predict_proba(X)
    got = tclf.predict_proba(X)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_array_equal(tclf.predict(X), jclf.predict(X))
    # A tensor goes in as well as an array, with the same result.
    np.testing.assert_array_equal(tclf.predict_proba(torch.from_numpy(X)), got)


def _fitted(cls, **kw):
    X, y = _data()
    clf = cls(hidden_layer_sizes=(8,), random_state=0, **kw)
    clf.partial_fit(X, y, classes=list(LABELS))
    return clf


ERRORS = {
    "unknown label": lambda clf: clf.partial_fit(_data()[0], np.array(["nope"] * 53)),
    "partial_fit width": lambda clf: clf.partial_fit(_data()[0][:, :4], _data()[1]),
    "predict width": lambda clf: clf.predict_proba(_data()[0][:, :4]),
    "3-D input": lambda clf: clf.predict_proba(np.zeros((2, 3, 12), np.float32)),
    "unfitted": None,
    "activation": None,
    "solver": None,
    "init": None,
    "class_weight missing": None,
    "class_weight negative": None,
    "set_params": lambda clf: clf.set_params(bogus=1),
}


def _raise(cls, case, **kw):
    if case == "unfitted":
        return cls(**kw).predict(np.zeros((1, 4), np.float32))
    if case in ("activation", "solver", "init"):
        bad = {"activation": "tanh", "solver": "sgd", "init": "he"}[case]
        return cls(**{case: bad}, **kw)
    if case.startswith("class_weight"):
        weights = ({"c0": 1.0} if case.endswith("missing")
                   else {c: -1.0 for c in LABELS})
        return _fitted(cls, class_weight=weights, **kw)
    return ERRORS[case](_fitted(cls, **kw))


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(case):
    with pytest.raises(Exception) as jerr:
        _raise(JMLP, case)
    with pytest.raises(Exception) as terr:
        _raise(TMLP, case, device="cpu")
    assert terr.type is jerr.type
    assert str(terr.value) == str(jerr.value)


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TMLP()
    with pytest.raises(RuntimeError, match="is_available"):
        classifier_from_arrays([np.zeros((4, 3), np.float32)],
                               [np.zeros(3, np.float32)], classes=LABELS)


@pytest.mark.parametrize("source", ["fortran", "tensor view"])
def test_carried_weights_are_contiguous_copies(source):
    """Weights with other strides (a fancy-indexed or transposed array, a
    tensor view) train exactly as C-ordered ones: the parameters are
    contiguous copies, so the products run the same kernels."""
    X, y = _data()
    rng = np.random.default_rng(4)
    weights = [rng.normal(0, 0.3, (12, 8)).astype(np.float32),
               rng.normal(0, 0.3, (8, 3)).astype(np.float32)]
    biases = [np.zeros(8, np.float32), np.zeros(3, np.float32)]
    if source == "fortran":
        odd = [np.asfortranarray(w) for w in weights]
    else:
        odd = [torch.from_numpy(np.ascontiguousarray(w.T)).T for w in weights]
    clfs = [classifier_from_arrays(ws, biases, classes=LABELS, device="cpu", **HYPER)
            for ws in (weights, odd)]
    for p in clfs[1]._params["W"]:
        assert p.is_contiguous() and p.is_leaf
    for clf in clfs:
        clf.partial_fit(X, y)
    assert clfs[0].loss_curve_ == clfs[1].loss_curve_
    for got, want in zip(clfs[1].coefs_, clfs[0].coefs_):
        np.testing.assert_array_equal(got, want)
    # The caller's arrays are not aliased.
    assert np.array_equal(np.asarray(odd[0]), weights[0])


def test_classifier_from_arrays_checks_class_count():
    with pytest.raises(ValueError, match="outputs for 2 classes"):
        classifier_from_arrays([np.zeros((4, 3), np.float32)],
                               [np.zeros(3, np.float32)], classes=["a", "b"],
                               device="cpu")


def test_steps_and_loss_curve_bookkeeping():
    X, y = _data(n=10, d=4)
    clf = TMLP((4,), batch_size=4, random_state=0, device="cpu")
    clf.partial_fit(X, y, classes=list(LABELS))
    assert clf._adam_state()["count"] == 3  # ceil(10 / 4)
    clf.partial_fit(X, y)
    assert clf._adam_state()["count"] == 6
    assert clf.n_iter_ == 2 and len(clf.loss_curve_) == 2


def test_get_set_params_match_jax():
    jp = JMLP(hidden_layer_sizes=(5,), alpha=0.5).get_params()
    tclf = TMLP(hidden_layer_sizes=(5,), alpha=0.5, device="cpu")
    tp = tclf.get_params()
    assert set(tp) == set(jp) | {"device"}
    assert {k: tp[k] for k in jp} == jp
    assert tclf.set_params(alpha=0.1).alpha == 0.1


def test_random_state_none_is_reproducible_under_np_seed():
    X, y = _data()

    def run():
        np.random.seed(123)
        clf = TMLP(hidden_layer_sizes=(8,), random_state=None, device="cpu")
        for _ in range(2):
            clf.partial_fit(X, y, classes=list(LABELS))
        return list(clf.loss_curve_)

    assert run() == run()


def test_deepcopy_is_independent_of_further_training():
    X, y = _data()
    clf = _fitted(TMLP, device="cpu")
    snap = copy.deepcopy(clf)
    before = snap.coefs_ + snap.intercepts_
    adam_before = {k: [t.clone() for t in v["W"]]
                   for k, v in snap._adam_state().items() if k != "count"}
    clf.partial_fit(X, y)
    for got, want in zip(snap.coefs_ + snap.intercepts_, before):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(clf.coefs_[0], snap.coefs_[0])
    state = snap._adam_state()
    assert state["count"] == 1  # one auto-sized batch of 53
    for name, tensors in adam_before.items():
        for got, want in zip(state[name]["W"], tensors):
            assert torch.equal(got, want)
    # The snapshot trains on from where it was taken, as the original did.
    twin = copy.deepcopy(snap)
    snap.partial_fit(X, y)
    twin.partial_fit(X, y)
    assert snap.loss_curve_ == twin.loss_curve_


def test_pickle_round_trip_restores_the_model():
    X, y = _data()
    clf = _fitted(TMLP, device="cpu", class_weight=CLASS_WEIGHT)
    restored = pickle.loads(pickle.dumps(clf))
    assert "_opt" not in clf.__getstate__()
    np.testing.assert_array_equal(clf.predict_proba(X[:10]),
                                  restored.predict_proba(X[:10]))
    clf.partial_fit(X, y)
    restored.partial_fit(X, y)
    assert clf.loss_curve_ == restored.loss_curve_
    for got, want in zip(restored.coefs_, clf.coefs_):
        np.testing.assert_array_equal(got, want)


def test_coefs_are_copies():
    clf = _fitted(TMLP, device="cpu")
    coefs = clf.coefs_
    coefs[0][:] = 0.0
    assert np.abs(clf.coefs_[0]).max() > 0


def test_training_forces_full_float32(monkeypatch):
    """Every product runs with TF32 off, whatever the caller set."""
    seen = []
    real = tmlp.mlp_logits

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*args)

    monkeypatch.setattr(tmlp, "mlp_logits", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    clf = _fitted(TMLP, device="cpu")
    clf.predict_proba(_data()[0])
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32
