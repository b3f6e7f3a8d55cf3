"""Seconds of set-up the program spent building or loading the port's CUDA
libraries (`ops.cuda_build`) (layer: set-up)."""

from benchmark import program_spans


def read(rec):
    return program_spans.setup_part_s(rec, program_spans.setup_counters(),
                                      "kernels")
