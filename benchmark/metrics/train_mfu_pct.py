"""The training step's share of the card's peak over the window: 6 FLOPs
per matmul weight per sample (``costs.train_flops_per_sample``) times the
samples consumed, over the window's seconds and the f32 peak (the step's
matmuls run with TF32 off)."""


def read(record):
    if not record.get("samples") or "flops_per_sample" not in record:
        return None
    return (100.0 * record["flops_per_sample"] * record["samples"]
            / record["window_s"] / record["peak_flops"])
