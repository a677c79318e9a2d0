"""Host ms per image of ``extract_features_async`` on the builder's main
thread over the window: upload, crop launch, trunk chunks enqueued (the
benchmark's proxy around the extractor)."""


def read(record):
    ms = record.get("spans", {}).get("dispatch")
    return sum(ms) / len(ms) if ms else None
