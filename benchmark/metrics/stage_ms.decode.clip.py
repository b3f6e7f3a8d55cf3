"""Device ms a clip job spends in the program's span `tsnet.decode`: the
phase decoder, the cast to f32 and the composite (layer: generator)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.decode"], "tsnet.clip.run",
                                     "clip_shape")
