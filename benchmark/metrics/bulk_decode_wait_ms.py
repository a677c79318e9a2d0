"""ms per image that the builder's main thread waited on the image's decode
over the window (the program's ``bucket.decode_wait`` span around the
decode future's result)."""

from benchmark.program_spans import mean_ms


def read(record):
    return mean_ms(record, "bucket.decode_wait")
