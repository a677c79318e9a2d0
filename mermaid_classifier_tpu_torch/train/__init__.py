"""Training lane of the PyTorch port: the MLP classifier head (streamed and
device-resident), its calibration and the epoch-loop trainer. Port of
``mermaid_classifier_tpu/train``; imports torch, numpy and (lazily, for the
host calibration fits) scipy."""
