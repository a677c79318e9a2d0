"""Helpers for the benchmark's own tests, which run on the CPU: each cell
cut to a size a test run holds, its limits as committed."""

import pytest
import torch

from benchmark.manifest import Manifest


def tiny_cell(name: str):
    cell = Manifest().cell(name)
    if cell.traffic["kind"] == "bulk":
        # Published widths and patch size; few, small images and points.
        cell.config["builder"]["verify_numerics"] = False
        cell.config["init"]["calib_patches"] = 8
        cell.traffic.update(image_sizes=[[300, 400], [280, 360], [240, 320]], points_per_image=6,
                            images_per_source=3, sources=2, jpeg_pool=3, warm_images=3,
                            trace_images=3, check_per_call=2, check_images=4)
    else:
        cell.config["head"]["layers"] = [256, 64, 32, 80]
        cell.traffic.update(rows=4000, call_rows=1000, trace_calls=1)
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
