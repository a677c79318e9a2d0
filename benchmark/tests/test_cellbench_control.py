"""``correct`` comes out false when the timed path is wrong: with the
control (the reference one precision below the configuration's, in the
program's place) and with each fault the cell can have, planted in the
program underneath a run that skips only the look for a card. Sizes are
cut so that a test run holds them; the limits are the committed ones."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.reference import efficientnet as ref_en
from benchmark.reference import mlp as ref_mlp
from benchmark.tests.conftest import tiny_cell
from mermaid_classifier_tpu_torch.models.extractor import FeatureExtractor
from mermaid_classifier_tpu_torch.train import mlp_classifier as mc

SEED = 2**31 + 3


def correct(name: str) -> tuple[bool, dict]:
    result = bench_run.run(tiny_cell(name), SEED, 0.3, False, "cpu")
    return result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["b2_bulk_200pt", "b0_head_train_c2"])
def test_the_program_passes(name):
    ok, checks = correct(name)
    assert ok, checks


def _fp8_trunk(self, patches):
    net = ref_en.EfficientNet(self.variables, self.config.to_dict(), patches.device,
                              precision="fp8")
    return net.forward(patches.float())


def _half_batch_mean(orig):
    def features(self, patches):
        keep = max(1, patches.shape[0] // 2)
        head = orig(self, patches[:keep])
        rest = head.mean(0, keepdim=True).expand(patches.shape[0] - keep, -1)
        return torch.cat([head, rest])
    return features


def _wrong_point(orig):
    def extract(self, image, rowcols):
        readback = orig(self, image, rowcols)
        host = readback._host
        host.copy_(host.flip(0))
        return readback
    return extract


@pytest.mark.parametrize("fault", ["fp8_control", "half_batch_mean", "answer_altered"])
@pytest.mark.parametrize("name", ["b2_bulk_200pt"])
def test_bulk_control_and_faults_fail(name, fault, monkeypatch):
    if fault == "fp8_control":
        monkeypatch.setattr(FeatureExtractor, "features_for_patches_device", _fp8_trunk)
    elif fault == "half_batch_mean":
        monkeypatch.setattr(FeatureExtractor, "features_for_patches_device",
                            _half_batch_mean(FeatureExtractor.features_for_patches_device))
    else:
        monkeypatch.setattr(FeatureExtractor, "extract_features_async",
                            _wrong_point(FeatureExtractor.extract_features_async))
    ok, checks = correct(name)
    assert not ok, checks


def _tf32_logits(weights, biases, x):
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = ref_mlp._TF32MatMul.apply(x, w) + b
        if i < len(weights) - 1:
            x = torch.relu(x)
    return x


def _half_batch(orig):
    def step(self, src, scale, class_w, batches, losses, counter, batch, shard=None):
        batches[:, 2 * batch] = torch.clamp(batches[:, 2 * batch] // 2, min=1)
        return orig(self, src, scale, class_w, batches, losses, counter, batch, shard)
    return step


def _counter_stuck(orig):
    def step(self, src, scale, class_w, batches, losses, counter, batch, shard=None):
        orig(self, src, scale, class_w, batches, losses, counter, batch, shard)
        counter.sub_(1)
    return step


def _bias_step_1(orig):
    def update(params, grads, adam, *args):
        adam["count"].zero_()
        return orig(params, grads, adam, *args)
    return update


@pytest.mark.parametrize("fault", ["tf32_control", "state_unchanged", "half_batch_mean",
                                   "counter_stuck", "bias_step_1"])
def test_training_control_and_faults_fail(fault, monkeypatch):
    if fault == "tf32_control":
        monkeypatch.setattr(mc, "mlp_logits", _tf32_logits)
    elif fault == "state_unchanged":
        monkeypatch.setattr(mc, "adam_update", lambda *args, **kwargs: None)
    elif fault == "half_batch_mean":
        monkeypatch.setattr(mc.MLPClassifier, "_adam_step", _half_batch(mc.MLPClassifier._adam_step))
    elif fault == "counter_stuck":
        monkeypatch.setattr(mc.MLPClassifier, "_adam_step",
                            _counter_stuck(mc.MLPClassifier._adam_step))
    else:
        monkeypatch.setattr(mc, "adam_update", _bias_step_1(mc.adam_update))
    ok, checks = correct("b0_head_train_c2")
    assert not ok, checks
