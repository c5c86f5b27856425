"""The control of each cell: the plain reference one precision step below
the configuration's (float8) in the program's place fails the cell's
comparison, at a size a CPU test can hold."""

import pytest
import torch

from portbench import compare as C
from portbench import control as CT
from portbench import harness as H

SIZES = {"xc16_serve_b16": ((64, 64), {"batch": 2, "pool_batches": 2,
                                       "warmup_calls": 1,
                                       "sample_calls": 1}),
         "mnv2_crf_b16": ((128, 128), {"batch": 2, "pool_batches": 2,
                                       "warmup_calls": 1,
                                       "sample_calls": 2}),
         "mnv2_train_b16": ((64, 64), {"batch": 4, "pool_batches": 3})}


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_fails(cell):
    size, over = SIZES[cell]
    limits = H.cell_files(H.benchmark(), cell)[1]["limits"]
    (seed, numbers), = CT.readings(
        cell, 0.5, [2 ** 31 + 7], {"quant": H.control_precision(cell)},
        device=torch.device("cpu"), size=size, overrides=over)
    assert not all(ok for *_, ok in C.judge(numbers, limits))
