"""Host ms per image of the raw image's upload to the card, on the builder's
main thread over the window (the program's ``extract.upload`` span in
``FeatureExtractor._upload``)."""

from benchmark.program_spans import mean_ms


def read(record):
    return mean_ms(record, "extract.upload")
