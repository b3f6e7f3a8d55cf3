"""Device ms a clip job spends in the program's span
`tsnet.encode_sources`: the source encoder (once a chunk, as the code
stands) (layer: generator)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.encode_sources"],
                                     "tsnet.clip.run", "clip_shape")
