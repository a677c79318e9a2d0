"""Host ms per training call before its first step over the window, while
the card has nothing of the call queued: checks, label indices, shuffle,
packing, the runner and the batches' copy (the program's ``train.prepare``
span in ``MLPClassifier.partial_fit_resident``)."""

from benchmark.program_spans import mean_ms


def read(record):
    return mean_ms(record, "train.prepare")
