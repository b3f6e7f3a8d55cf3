"""Device ms a train step spends in the program's span
`tsnet.train.d_phase`: the discriminators' losses on the detached
reconstruction (and netDF's face crops) and their backward (layer: train
step)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.train.d_phase"],
                                     "tsnet.train.step", "train_shape")
