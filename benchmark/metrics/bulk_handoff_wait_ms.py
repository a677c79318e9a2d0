"""ms per image that the builder's main thread spent handing the image to
the writer over the window; it blocks while the writer's queue holds two
(the program's ``bucket.handoff`` span)."""

from benchmark.program_spans import mean_ms


def read(record):
    return mean_ms(record, "bucket.handoff")
