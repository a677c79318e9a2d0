"""Host ms per JPEG decode in the builder's decode threads over the window
(the benchmark's timed ``decode_image`` wrapper)."""


def read(record):
    ms = record.get("spans", {}).get("decode")
    return sum(ms) / len(ms) if ms else None
