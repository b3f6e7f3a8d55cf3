"""Seconds of set-up the program spent constructing the port's modules
(`TSNetModules`, `create_train_state`) (layer: set-up)."""

from benchmark import program_spans


def read(rec):
    return program_spans.setup_part_s(rec, program_spans.setup_counters(),
                                      "modules")
