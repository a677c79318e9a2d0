"""The plain references (``benchmark/reference/``) against the port's CPU
path at a tiny size: the same weights and inputs give the same numbers."""

import numpy as np
import torch

from benchmark import compare, weights
from benchmark.corpus import smooth_field
from benchmark.reference import efficientnet as ref_en
from benchmark.reference import mlp as ref_mlp


def tiny_backbone(dtype="float32"):
    return {"stem_channels": 8, "stages": [[1, 8, 1, 1, 3], [6, 16, 2, 2, 3], [4, 24, 2, 2, 5]],
            "head_channels": 32, "se_ratio": 0.25, "feature_dim": 48,
            "mean_rgb": [0.485, 0.456, 0.406], "std_rgb": [0.229, 0.224, 0.225],
            "patch_size": 32, "compute_dtype": dtype, "padding": "symmetric", "bn_eps": 0.001}


INIT = {"conv_gain": 1.0, "dense_gain": 1.0, "bn_gain": 0.5, "bn_spread": 0.1, "bias_spread": 0.1,
        "calib_patches": 8}


def test_crop_matches_the_ports_plain_crop():
    from mermaid_classifier_tpu_torch.ops.patch_ops import channel_scale_bias, extract_patches_plain

    rng = np.random.default_rng(1)
    image = smooth_field(rng, 64, 96)
    rowcols = np.array([[0, 0], [63, 95], [30, 40], [5, 90]], np.int32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    scale, bias = channel_scale_bias(mean, std)
    want = extract_patches_plain(torch.from_numpy(image), torch.from_numpy(rowcols), 32,
                                 torch.from_numpy(scale), torch.from_numpy(bias), pad=16)
    got = ref_en.crop(image, rowcols, 32, mean, std)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_efficientnet_matches_the_ports_f32_forward():
    from mermaid_classifier_tpu_torch.models.efficientnet import EfficientNetConfig
    from mermaid_classifier_tpu_torch.models.extractor import FeatureExtractor

    bb = tiny_backbone()
    variables = weights.backbone_variables(bb, INIT, 5, "cpu")
    rng = np.random.default_rng(2)
    image = smooth_field(rng, 64, 96)
    rowcols = np.stack([rng.integers(0, 64, 6), rng.integers(0, 96, 6)], 1).astype(np.int32)
    want = ref_en.EfficientNet(variables, bb, "cpu").features(
        ref_en.crop(image, rowcols, 32, bb["mean_rgb"], bb["std_rgb"])).numpy()
    for impl in ("module", "folded", "fused"):
        ex = FeatureExtractor(variables, EfficientNetConfig.from_dict(bb), device="cpu",
                              backbone_impl=impl)
        assert compare.feature_gap([ex.extract_features(image, rowcols)], [want]) < 1e-5, impl


def test_fp8_control_departs_from_f32():
    bb = tiny_backbone()
    variables = weights.backbone_variables(bb, INIT, 5, "cpu")
    patches = torch.randn(4, 32, 32, 3)
    f32 = ref_en.EfficientNet(variables, bb, "cpu").features(patches).numpy()
    fp8 = ref_en.EfficientNet(variables, bb, "cpu", precision="fp8").features(patches).numpy()
    assert compare.feature_gap([fp8], [f32]) > 1e-2


def test_tf32_round_keeps_ten_mantissa_bits_nearest_even():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 3 * 2 ** -11)])
    assert ref_mlp.tf32_round(x).tolist() == [1.0, 1.0, 1 + 2 ** -9, -(1 + 2 ** -9)]


def test_adam_calls_match_the_ports_classifier():
    from mermaid_classifier_tpu_torch.train.mlp_classifier import classifier_from_arrays

    layers = [64, 20, 12, 8]
    head = {"learning_rate": 1e-3, "alpha": 1e-4, "beta_1": 0.9, "beta_2": 0.999,
            "epsilon": 1e-8, "batch_size": 30, "random_state": 5}
    w0, b0 = weights.xavier_head(layers, 3, "cpu")
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.integers(-127, 128, size=(200, 64)).astype(np.int8))
    scale = rng.uniform(0.5, 1.5, 200).astype(np.float32) / 127
    y = rng.integers(0, 8, 200)
    cw = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    clf = classifier_from_arrays(w0, b0, classes=np.arange(8), device="cpu",
                                 learning_rate_init=1e-3, batch_size=30, random_state=5,
                                 class_weight={c: float(w) for c, w in enumerate(cw)})
    clf.set_resident_features_storage(q, scale)
    # Calls of 95 rows: three full batches and a short one each.
    calls, losses = [], []
    for rows in rng.permutation(200)[:190].reshape(2, 95):
        clf.partial_fit_resident(rows, y[rows])
        losses.append(clf.loss_curve_[-1])
        calls.append((q[torch.from_numpy(rows)], scale[rows], y[rows]))
    ref = ref_mlp.adam_calls(w0, b0, calls, cw, head, "cpu")
    assert compare.loss_gap(losses, ref["losses"]) < 1e-6
    mu = clf.__getstate__()["_opt_state_state"]["mu"]
    assert compare.leaf_norm_gap([*mu["W"], *mu["b"]], ref["moments"]) < 1e-5
    start = [*w0, *b0]
    moved = [p - s for p, s in zip([*clf.coefs_, *clf.intercepts_], start)]
    assert compare.leaf_norm_gap(moved, [p - s for p, s in zip(ref["params"], start)]) < 1e-4
    # Onward from the program's own state: one more call of one batch.
    state = clf.__getstate__()
    adam = state["_opt_state_state"]
    after = [*state["_params_state"]["W"], *state["_params_state"]["b"]]
    moments = {"mu": [*adam["mu"]["W"], *adam["mu"]["b"]],
               "nu": [*adam["nu"]["W"], *adam["nu"]["b"]], "count": adam["count"]}
    last = rng.permutation(200)[:30]
    clf.partial_fit_resident(last, y[last])
    onward = ref_mlp.adam_calls(after[:3], after[3:], [(q[torch.from_numpy(last)], scale[last],
                                                       y[last])], cw, head, "cpu", moments=moments)
    assert compare.loss_gap(clf.loss_curve_[-1:], onward["losses"]) < 1e-6
    moved = [p - s for p, s in zip([*clf.coefs_, *clf.intercepts_], after)]
    assert compare.leaf_norm_gap(moved, [p - s for p, s in zip(onward["params"], after)]) < 1e-4
    tf32 = ref_mlp.adam_calls(w0, b0, calls, cw, head, "cpu", tf32=True)
    assert compare.loss_gap(tf32["losses"], ref["losses"]) > 1e-5
    for fault in ref_mlp.FAULTS:
        bad = ref_mlp.adam_calls(w0, b0, calls, cw, head, "cpu", fault=fault)
        moved_bad = [p - s for p, s in zip(bad["params"], start)]
        assert compare.leaf_norm_gap(moved_bad, [p - s for p, s in zip(ref["params"], start)]) > 1e-3


def test_call_batches_follow_the_seeded_shuffle():
    batches = ref_mlp.call_batches(95, 30, 5)
    order = np.arange(95)
    np.random.default_rng(5).shuffle(order)
    assert [len(b) for b in batches] == [30, 30, 30, 5]
    assert np.array_equal(np.concatenate(batches), order)
