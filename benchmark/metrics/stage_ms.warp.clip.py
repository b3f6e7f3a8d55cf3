"""Device ms a clip job spends in the program's span `tsnet.warp`: the
transformation branch (K1, or K3-nf and the mean) (layer: generator)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.warp"], "tsnet.clip.run",
                                     "clip_shape")
