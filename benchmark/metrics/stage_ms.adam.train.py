"""Device ms a train step spends in the program's spans `tsnet.train.d_opt`
and `tsnet.train.g_opt`: both Adam updates (layer: train step)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(
        rec, program_spans.registry(),
        ["tsnet.train.d_opt", "tsnet.train.g_opt"], "tsnet.train.step",
        "train_shape")
