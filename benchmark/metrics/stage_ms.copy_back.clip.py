"""Device ms a clip job spends in the program's span
`tsnet.clip.copy_back`: the frames' concatenation, permute and copy to
the host (layer: clip I/O)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.clip.copy_back"],
                                     "tsnet.clip.run", "clip_shape")
