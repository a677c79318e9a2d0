"""Host ms per image of the extractor's dispatch after the upload, on the
builder's main thread over the window: validation, crop launch, trunk
chunks, the pinned readback copy and its event (the program's
``extract.dispatch`` spans less the ``extract.upload`` spans within
them)."""

from benchmark.program_spans import total_ms, window


def read(record):
    spans = window(record)
    dispatches = spans.get("extract.dispatch")
    if not dispatches:
        return None
    first = min(s.start_ns for s in dispatches)
    uploads = [s for s in spans.get("extract.upload", []) if s.start_ns >= first]
    return (total_ms(dispatches) - total_ms(uploads)) / len(dispatches)
