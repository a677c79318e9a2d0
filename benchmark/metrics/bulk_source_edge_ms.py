"""ms per source call over the window at the call's two edges, where the
card has at most the last image's work: opening the source (annotations,
their copy, the partial-write sweep, the listing) and draining the writer
(the program's ``bucket.open`` and ``bucket.drain`` spans)."""

from benchmark.program_spans import total_ms, window


def read(record):
    spans = window(record)
    opened = spans.get("bucket.open")
    if not opened:
        return None
    return (total_ms(opened) + total_ms(spans.get("bucket.drain", []))) / len(opened)
