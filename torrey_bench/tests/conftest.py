"""Shared pieces of the benchmark's CPU tests: one torch thread a process,
and tiny frames of the cells."""

import pytest
import torch

from torrey_bench import spec

torch.set_num_threads(2)

# a frame small enough for the CPU; the large scene unsubdivided
TINY = {"width": 32, "height": 24, "max_depth": 4}
TINY_LARGE = dict(TINY, subdivide_levels=0)
CELLS = ("blob_box_x3-wavefront-spf2", "cbox_rect-spf2",
         "blob_box_x3-bricks-spf2", "blob_box_x3-wavefront-spf10")


def tiny(cell_name: str) -> dict:
    return TINY if cell_name.startswith("cbox") else TINY_LARGE


@pytest.fixture(scope="session")
def cells():
    return {name: spec.load_cell(name) for name in CELLS}
