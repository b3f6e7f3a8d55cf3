"""Device ms a clip job spends in the program's span `tsnet.lbl_enc`: the
label encoder and the L2 norm (layer: generator)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.lbl_enc"], "tsnet.clip.run",
                                     "clip_shape")
