"""Device ms a clip job spends in the program's span `tsnet.fuse`: FuseNet
with K2 (layer: generator)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.fuse"], "tsnet.clip.run",
                                     "clip_shape")
