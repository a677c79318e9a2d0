"""Writer-thread ms per image over the window: the feature file's write to
the target store and the progress record (the program's ``bucket.write``
span)."""

from benchmark.program_spans import mean_ms


def read(record):
    return mean_ms(record, "bucket.write")
