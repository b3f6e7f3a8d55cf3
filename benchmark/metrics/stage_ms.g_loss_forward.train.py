"""Device ms a train step spends in the program's span
`tsnet.train.g_loss_forward`: the G phase's losses, read through the
updated discriminators (layer: train step)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.train.g_loss_forward"],
                                     "tsnet.train.step", "train_shape")
