"""CUDA-graph captures of the Adam step within the window (the program's
``train.capture`` spans); 0 where the window only replays what set-up
captured. None where the window holds no training call."""

from benchmark.program_spans import window


def read(record):
    spans = window(record)
    if not spans.get("train.call"):
        return None
    return len(spans.get("train.capture", []))
