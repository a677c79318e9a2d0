"""Shared fixtures of the port's training-lane tests: one set of seeded
per-image feature files read by both packages' label containers."""

from mermaid_classifier_tpu.data import labels as jlabels
from mermaid_classifier_tpu_torch.data import labels as tlabels

from tests.data.test_labels import build_synthetic_labels


def port_labels(jax_labels) -> tlabels.ImageLabels:
    """The port's ImageLabels over the same files and annotations."""
    out = tlabels.ImageLabels()
    for key, anns in jax_labels.data.items():
        out.add_image(key, list(anns))
    return out


def synthetic_tasks(tmp_path, split_ratios=(0.15, 0.15), **kw):
    """(JAX TrainingTaskLabels, port TrainingTaskLabels) of one seeded set
    of feature files (``build_synthetic_labels``), each split by its own
    package's ``preprocess_labels``."""
    labels, _ = build_synthetic_labels(tmp_path, **kw)
    return (jlabels.preprocess_labels(labels, split_ratios=split_ratios),
            tlabels.preprocess_labels(port_labels(labels),
                                      split_ratios=split_ratios))
