"""Training lane of the PyTorch port: the MLP classifier head and its
calibration. Port of ``mermaid_classifier_tpu/train``; imports torch, numpy
and (lazily, for the host calibration fits) scipy."""
