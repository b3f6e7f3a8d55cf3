"""Device ms a train step spends in the program's span
`tsnet.train.g_backward`: the G loss's backward and the zero-gradient
fill (layer: train step)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.train.g_backward"],
                                     "tsnet.train.step", "train_shape")
