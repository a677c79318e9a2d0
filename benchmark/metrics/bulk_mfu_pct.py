"""The whole extraction's share of the card's peak over the window: trunk
FLOPs per patch (``costs.trunk_flops_per_patch``) times the patches
written, over the window's seconds and the compute dtype's peak."""


def read(record):
    if not record.get("patches") or "flops_per_patch" not in record:
        return None
    return (100.0 * record["flops_per_patch"] * record["patches"]
            / record["window_s"] / record["peak_flops"])
