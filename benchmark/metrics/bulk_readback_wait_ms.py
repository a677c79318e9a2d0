"""ms per image that the builder's writer thread waited for the image's
features to reach the host over the window (the program's
``bucket.readback_wait`` span around ``FeatureReadback.wait``)."""

from benchmark.program_spans import mean_ms


def read(record):
    return mean_ms(record, "bucket.readback_wait")
